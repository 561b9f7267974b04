"""The benchmark's tests run on the CPU from the repository root:
``python -m pytest perfbench/tests``.  They put ``src/`` and the root on
the path, as ``perfbench/run.py`` does."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)
