"""Static protocol analysis: guarded-action model checking + sanitizers
(the port of ``repro.analysis``).

``model``    -- Tables I-III as explicit guarded transitions over bounded
                state tuples (per-core pts, private lines, LLC, mts).
``explore``  -- BFS exhaustive enumerator with invariant checking and
                counterexample witness traces.
``bridge``   -- cross-validation of every enumerated transition against the
                port's ``core.protocol`` scalars and its ``LeaseEngine``
                (numpy mirror, or the device backend: K1 / K2 on the card).
``sanitize`` -- the runtime lease sanitizer behind ``TARDIS_SANITIZE=1`` /
                ``LeaseEngine(sanitize=True)``.
"""
from .model import Config, Rules, TardisModel  # noqa: F401
from .explore import ExploreResult, Violation, explore  # noqa: F401
from .bridge import Bridge  # noqa: F401
from .sanitize import LeaseSanitizer, SanitizeError  # noqa: F401
