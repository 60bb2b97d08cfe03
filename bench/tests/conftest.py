"""The benchmark's tests import its modules and the port's as the harness
does: ``bench/`` and ``src/`` on the path."""
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]
for p in (_ROOT / "bench", _ROOT / "bench" / "tests", _ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
