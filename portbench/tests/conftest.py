"""Settings of the benchmark's own tests (``python -m pytest portbench/tests``,
from the root of the repo). Every test here runs on the CPU at a tiny size
or on data alone; what needs the card is measured by ``portbench/run.py``
and ``portbench/control.py`` there."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
