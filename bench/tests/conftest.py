"""The benchmark's own tests: ``python -m pytest -q bench/tests`` from
the root of the checkout.  Tests marked ``cuda`` run on the card and
skip elsewhere."""

import sys
from pathlib import Path

_BENCH = Path(__file__).resolve().parents[1]
for p in (_BENCH.parent / "src", _BENCH, Path(__file__).resolve().parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
