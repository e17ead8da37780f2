"""The ``vietTTS`` drop-in import shim over the port
(``viettts_tpu_torch/compat/vietTTS``) against the JAX package's
(``compat/vietTTS``), on the CPU.

Each shim directory is put on ``sys.path`` only inside a fixture, and
every ``vietTTS*`` module is evicted from ``sys.modules`` afterwards, as
``tests/test_compat_shim.py`` does, so the two shims (one import name)
never meet and other tests see neither.  The waveforms are compared at
tiny widths on seeded checkpoints (``tests/test_torch_pipeline.py``'s),
float32 route: mel 1e-4, wave 1e-3 (BASELINE.md's bar).
"""

import contextlib
import inspect
import sys
import wave
from pathlib import Path

import numpy as np
import pytest

from test_torch_pipeline import _cfg, _write_checkpoints, port_config

REPO = Path(__file__).resolve().parents[1]
JAX_SHIM = REPO / "compat"
PORT_SHIM = REPO / "viettts_tpu_torch" / "compat"
TEXT = "xin chào các bạn"


@contextlib.contextmanager
def _shim(directory: Path):
    """``directory`` first on ``sys.path``; its ``vietTTS`` modules dropped
    on the way out."""
    sys.path.insert(0, str(directory))
    before = set(sys.modules)
    try:
        yield
    finally:
        sys.path.remove(str(directory))
        for name in set(sys.modules) - before:
            if name == "vietTTS" or name.startswith("vietTTS."):
                del sys.modules[name]


@pytest.fixture()
def port_shim():
    from viettts_tpu_torch import infer

    with _shim(PORT_SHIM):
        yield
    infer.clear_synthesizer_cache()


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return _write_checkpoints(_cfg(), tmp_path_factory.mktemp("torch_shim_ckpts"))


def test_port_shim_is_not_a_port_package():
    """The shim's parent directory has no ``__init__.py``: it is reached
    by ``PYTHONPATH``, never as ``viettts_tpu_torch.compat``."""
    assert not (PORT_SHIM / "__init__.py").exists()
    assert (PORT_SHIM / "vietTTS" / "__init__.py").exists()


def test_shim_maps_to_the_port(port_shim):
    import vietTTS.hifigan.mel2wave as m2w
    import vietTTS.nat.text2mel as t2m
    import vietTTS.synthesizer as syn

    from viettts_tpu_torch import infer
    from viettts_tpu_torch.synthesizer import main as port_main
    from viettts_tpu_torch.text import normalize_text

    assert Path(sys.modules["vietTTS"].__file__).parent == PORT_SHIM / "vietTTS"
    assert syn.main.__wrapped__ is port_main
    assert syn.nat_normalize_text is normalize_text
    # the reference's signatures (lexicon_fn positional)
    assert list(inspect.signature(t2m.text2mel).parameters) == ["text", "lexicon_fn", "silence_duration"]
    assert list(inspect.signature(m2w.mel2wave).parameters) == ["mel"]
    assert t2m.text2mel.__module__ == "vietTTS.nat.text2mel"
    assert m2w._infer is infer and t2m._infer is infer


def test_shim_defaults_to_float32_parity_route_on_the_card(port_shim):
    """As the JAX shim: every entry point pins the float32 route, while
    the port's own default stays bf16; the free functions run on the card
    unless ``vietTTS.DEVICE`` says otherwise."""
    import vietTTS
    import vietTTS.hifigan.mel2wave as m2w
    import vietTTS.nat.text2mel as t2m
    import vietTTS.synthesizer as syn

    from viettts_tpu_torch import infer
    from viettts_tpu_torch.config import Config

    assert Config().hifigan.inference_dtype == "bfloat16"
    assert vietTTS.PARITY_CFG.hifigan.inference_dtype == "float32"
    assert vietTTS.DEVICE == "cuda"
    assert syn.main.keywords["default_overrides"] == ("hifigan.inference_dtype=float32",)

    captured = []

    class _FakeSynth:
        def synthesize(self, text, silence_duration):
            class R:
                mel = np.zeros((4, 80), np.float32)

            return R()

        def vocode(self, mel):
            return np.zeros((mel.shape[0], 256), np.float32)

    orig = infer.get_synthesizer
    infer.get_synthesizer = lambda **kwargs: captured.append(kwargs) or _FakeSynth()
    try:
        t2m.text2mel("xin chào")
        m2w.mel2wave(np.zeros((4, 80), np.float32))
    finally:
        infer.get_synthesizer = orig
    assert len(captured) == 2
    for kwargs in captured:
        assert kwargs["cfg"].hifigan.inference_dtype == "float32" and kwargs["device"] == "cuda"


def test_shim_matches_the_jax_shim(ckpt_dir, monkeypatch):
    """``text2mel`` then ``mel2wave`` through each shim, each at the tiny
    float32 config on the same checkpoints: the port's mel and waveform
    are JAX's."""
    from viettts_tpu import infer as jax_infer

    cfg = _cfg(ckpt_dir)
    with _shim(JAX_SHIM):
        import vietTTS.hifigan.mel2wave as m2w
        import vietTTS.nat.text2mel as t2m

        monkeypatch.setattr(t2m, "PARITY_CFG", cfg)
        monkeypatch.setattr(m2w, "PARITY_CFG", cfg)
        want_mel = t2m.text2mel(TEXT)
        want_wave = m2w.mel2wave(want_mel)
        monkeypatch.undo()
    jax_infer.clear_synthesizer_cache()

    from viettts_tpu_torch import infer

    with _shim(PORT_SHIM):
        import vietTTS
        import vietTTS.hifigan.mel2wave as m2w
        import vietTTS.nat.text2mel as t2m

        assert Path(vietTTS.__file__).parent == PORT_SHIM / "vietTTS"
        vietTTS.PARITY_CFG, vietTTS.DEVICE = port_config(cfg), "cpu"
        mel = t2m.text2mel(TEXT)
        got = m2w.mel2wave(mel)
    infer.clear_synthesizer_cache()
    assert mel.shape == want_mel.shape and got.shape == want_wave.shape == (mel.shape[0] * 256,)
    np.testing.assert_allclose(mel, want_mel, atol=1e-4)
    np.testing.assert_allclose(got, want_wave, atol=1e-3)


def test_shim_cli_writes_the_float32_route(ckpt_dir, tmp_path, monkeypatch, port_shim):
    """``python -m vietTTS.synthesizer`` over the port: with the config's
    own route bf16, the shim's CLI writes the float32 route's audio (the
    port's Synthesizer on that route, as 16-bit PCM)."""
    import dataclasses

    import vietTTS.synthesizer as syn

    import viettts_tpu_torch.config as config_mod
    from viettts_tpu_torch.audio import pcm16
    from viettts_tpu_torch.infer.pipeline import Synthesizer

    tiny = port_config(_cfg())
    bf16 = tiny.replace(hifigan=dataclasses.replace(tiny.hifigan, inference_dtype="bfloat16"))
    monkeypatch.setattr(config_mod, "Config", lambda: bf16)
    out = tmp_path / "clip.wav"
    assert syn.main(["--text", TEXT, "--output", str(out), "--ckpt-dir", str(ckpt_dir), "--device", "cpu"]) == 0
    with wave.open(str(out), "rb") as w:
        pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    want = Synthesizer(tiny.replace(ckpt_dir=ckpt_dir), device="cpu").synthesize(TEXT).wave
    np.testing.assert_array_equal(pcm, pcm16(want))
