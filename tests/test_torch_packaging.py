"""The port installs whole: ``pyproject.toml`` names every package of
``viettts_tpu_torch`` and the port's console scripts (read with
``tomllib``; the setuptools build is not run)."""

import importlib
import tomllib
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def _pyproject():
    with open(REPO / "pyproject.toml", "rb") as f:
        return tomllib.load(f)


def test_every_port_package_is_listed():
    """A non-editable ``pip install .`` ships only the listed packages: each
    directory of the port with an ``__init__.py`` must be one of them."""
    listed = set(_pyproject()["tool"]["setuptools"]["packages"])
    on_disk = {".".join(p.parent.relative_to(REPO).parts) for p in (REPO / "viettts_tpu_torch").rglob("__init__.py")}
    assert {"viettts_tpu_torch.train", "viettts_tpu_torch.tools", "viettts_tpu_torch.utils"} <= on_disk
    assert on_disk - listed == set()
    assert {p for p in listed if p.startswith("viettts_tpu_torch")} == on_disk


@pytest.mark.parametrize("script,target", [
    ("viettts-torch-synthesize", "viettts_tpu_torch.synthesizer:main"),
    ("viettts-torch-serve", "viettts_tpu_torch.serve:main"),
])
def test_port_console_scripts(script, target):
    """Beside the JAX package's ``viettts-synthesize`` / ``viettts-serve``,
    each pointing at a ``main`` the port defines."""
    scripts = _pyproject()["project"]["scripts"]
    assert scripts[script] == target
    assert scripts[script.replace("-torch", "")] == target.replace("viettts_tpu_torch", "viettts_tpu")
    module, func = target.split(":")
    assert callable(getattr(importlib.import_module(module), func))
