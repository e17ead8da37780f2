"""The sizes of ``configs/viettts-infore.json``, for the tests."""

import json
from pathlib import Path

SIZES = json.loads((Path(__file__).resolve().parents[1] / "configs" / "viettts-infore.json").read_text())["sizes"]
