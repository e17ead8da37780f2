"""The benchmark's own tests: ``python -m pytest perfbench/tests -q`` from
the repository's root (card tests: ``-m gpu`` on a machine with a card)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
