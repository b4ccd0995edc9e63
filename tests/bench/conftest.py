"""The benchmark's CPU tests: ``perfbench`` is imported from the checkout's
root; the parent conftest keeps JAX on the CPU with virtual devices."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
