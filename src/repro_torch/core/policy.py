"""CoherencePolicy: one object for the whole coherence configuration.

Tardis 2.0 (arXiv 1511.08774) adds two orthogonal knobs to the base
timestamp protocol -- per-block lease self-tuning and relaxed consistency
models that drop renewals the memory model does not require.  Both used to
arrive as loose ``kv_lease`` / ``ts_bits`` kwargs scattered across the
lease engine, the sharded directory and the serving clusters; this
dataclass is the single source of truth they all accept as ``policy=``.
(A copy of ``repro.core.policy``: the port imports nothing of the JAX
package.)

Consistency models (which renewals a decode pod may skip):

  * ``sc``  -- sequential consistency: every expired lease renews (the
    paper's baseline; Table III verbatim).
  * ``tso`` -- total store order: a load may order BEFORE program-earlier
    stores/ticks of its own core (the classic store->load relaxation), so
    a tag-checked read-only block whose lease merely aged out under the
    core's own pts advance is served without a renewal round-trip.
  * ``rc``  -- release consistency: additionally loads may reorder with
    program-earlier loads; the serving layer treats it like ``tso`` (the
    decode access pattern has no load->load ordering to relax further).

Lease prediction (``predictor=True``): each block self-tunes its lease
inside ``[lease_min, lease_max]`` -- grow on a data-less renewal from a
holder of a cached copy (that requester's lease aged out before the
version changed: the message was wasted traffic), shrink on a write (the
lease blocked the writer).  MRSW livelock-freedom: writes always jump ahead of
the granted rts regardless of the predicted lease, so a reader can never
starve a writer; the bounds cap how far prediction may stretch either way.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

CONSISTENCY_MODELS = ("sc", "tso", "rc")


@dataclass(frozen=True)
class CoherencePolicy:
    """Consistency model + lease bounds + predictor settings + ts_bits.

    ``lease`` is the base (and initial predicted) lease.  With the
    predictor off the bounds collapse to ``lease`` exactly, so every
    engine stays bit-identical to the static protocol.  With the
    predictor on the bounds default to ``[max(1, lease // 4), lease * 8]``
    unless given explicitly.
    """

    consistency: str = "sc"
    lease: int = 64
    lease_min: int | None = None
    lease_max: int | None = None
    predictor: bool = False
    ts_bits: int = 30

    def __post_init__(self):
        if self.consistency not in CONSISTENCY_MODELS:
            raise ValueError(
                f"consistency must be one of {CONSISTENCY_MODELS}, "
                f"got {self.consistency!r}")
        if self.lease < 1:
            raise ValueError(f"lease must be >= 1, got {self.lease}")
        lo = self.lease_min
        hi = self.lease_max
        if lo is None:
            lo = max(1, self.lease // 4) if self.predictor else self.lease
        if hi is None:
            hi = self.lease * 8 if self.predictor else self.lease
        object.__setattr__(self, "lease_min", int(lo))
        object.__setattr__(self, "lease_max", int(hi))
        if not (1 <= self.lease_min <= self.lease <= self.lease_max):
            raise ValueError(
                f"need 1 <= lease_min <= lease <= lease_max, got "
                f"[{self.lease_min}, {self.lease}, {self.lease_max}]")
        if self.ts_bits < 2:
            raise ValueError(f"ts_bits must be >= 2, got {self.ts_bits}")

    # -- predictor step rules (shared by engine, directory and oracles so
    #    adaptive leases stay bit-identical everywhere) ------------------

    def grow(self, cur: int) -> int:
        """Next lease after a wasted (data-less) renewal."""
        return min(self.lease_max, int(cur) * 2)

    def shrink(self, cur: int) -> int:
        """Next lease after a write hit the block (lease blocked it)."""
        return max(self.lease_min, int(cur) // 2)

    def skip_expired_renewal(self) -> bool:
        """True when the model lets decode serve a tag-checked read-only
        block past its lease end without a renewal message."""
        return self.consistency != "sc"

    def with_(self, **kw) -> "CoherencePolicy":
        return replace(self, **kw)

    @classmethod
    def from_legacy(cls, lease: int = 64, ts_bits: int = 30,
                    **kw) -> "CoherencePolicy":
        """Build from the pre-policy kwarg spelling (``kv_lease``/``lease``
        + ``ts_bits``)."""
        return cls(lease=lease, ts_bits=ts_bits, **kw)


def resolve_policy(policy: "CoherencePolicy | None", *, lease=None,
                   ts_bits=None, default_lease: int = 64,
                   default_ts_bits: int = 30) -> "CoherencePolicy":
    """Fold legacy ``lease``/``ts_bits`` kwargs and an optional ``policy``
    into one CoherencePolicy (explicit legacy kwargs win over defaults;
    a given policy wins over everything)."""
    if policy is not None:
        return policy
    return CoherencePolicy(
        lease=default_lease if lease is None else int(lease),
        ts_bits=default_ts_bits if ts_bits is None else int(ts_bits))
