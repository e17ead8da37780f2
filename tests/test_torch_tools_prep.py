"""The port's corpus-preparation tools and trace hook against the JAX
package's, on the CPU.

* ``tools.denoise``: ``_stft``, ``_istft`` and ``spectral_gate`` (float64
  torch) within 1e-9 of the JAX tool's numpy on seeded noise plus a tone,
  and with digital silence, where many frames tie on energy; the CLI's
  samples within 1 int16 LSB of the JAX CLI's; no onnxruntime import
  without ``--nsnet2``.
* ``tools.build_lexicon``: the same bytes as JAX's.
* ``tools.align``: the same corpus, lexicon and ``mfa`` command lines as
  JAX's, with a fake ``mfa`` on ``PATH`` that records its arguments and
  writes TextGrids; the same message when the binary is missing.
* ``utils.profiling``: ``trace()`` writes a trace into
  ``$VIETTTS_PROFILE_DIR`` and nothing without it; a trainer run with it
  set leaves a trace file; ``StepTimer`` counts.
"""

import os
import subprocess
import sys
import wave as wave_mod
from pathlib import Path

import numpy as np
import pytest
import torch

from viettts_tpu.tools import align as jax_align
from viettts_tpu.tools import build_lexicon as jax_build_lexicon
from viettts_tpu.tools import denoise as jax_denoise
from viettts_tpu_torch.audio import read_wav, write_wav
from viettts_tpu_torch.tools import align, build_lexicon, denoise
from viettts_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
SR = 16000


def _tone_plus_noise(seed=0, seconds=2.0, silence=False):
    rng = np.random.RandomState(seed)
    t = np.arange(int(SR * seconds)) / SR
    tone = 0.5 * np.sin(2 * np.pi * 220 * t)
    tone[: SR // 2] = 0.0
    x = tone + rng.randn(len(t)) * 0.02
    if silence:  # zeroed segments, as tools.zero_silence_segments leaves them
        x[: SR // 4] = 0.0
        x[-SR // 5:] = 0.0
    return x.astype(np.float32)


@pytest.mark.parametrize("n_fft,hop", [(1024, 256), (512, 160)])
def test_stft_istft_match_numpy(n_fft, hop):
    x = _tone_plus_noise(1).astype(np.float64)
    want = jax_denoise._stft(x, n_fft, hop)
    got = denoise._stft(torch.from_numpy(x), n_fft, hop)
    assert got.dtype == torch.complex128 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-9, rtol=0)
    spec = want * np.random.RandomState(2).uniform(0.1, 1.0, want.shape)
    np.testing.assert_allclose(denoise._istft(torch.from_numpy(spec), n_fft, hop, len(x)).numpy(),
                               jax_denoise._istft(spec, n_fft, hop, len(x)), atol=1e-9, rtol=0)
    np.testing.assert_allclose(denoise._istft(got, n_fft, hop, len(x)).numpy(), x, atol=1e-8, rtol=0)


@pytest.mark.parametrize("silence", [False, True])
@pytest.mark.parametrize("strength", [2.0, 4.0])
def test_spectral_gate_matches_numpy(silence, strength):
    x = _tone_plus_noise(3, silence=silence)
    want = jax_denoise.spectral_gate(x, SR, strength=strength)
    got = denoise.spectral_gate(x, SR, strength=strength, device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-9, rtol=0)
    # a short clip: the reflect padding is longer than the clip
    short = x[:300]
    np.testing.assert_allclose(denoise.spectral_gate(short, SR, device="cpu"),
                               jax_denoise.spectral_gate(short, SR), atol=1e-9, rtol=0)


def test_denoise_cli_matches_jax(tmp_path):
    src, mine, theirs = tmp_path / "in", tmp_path / "port", tmp_path / "jax"
    src.mkdir()
    for i in range(3):
        write_wav(src / f"u{i}.wav", _tone_plus_noise(10 + i, seconds=1.0 + 0.3 * i, silence=i == 2), SR)
    onnx_loaded = "onnxruntime" in sys.modules
    denoise.main(["-i", str(src), "-o", str(mine), "--device", "cpu"])
    assert ("onnxruntime" in sys.modules) == onnx_loaded
    jax_denoise.main(["-i", str(src), "-o", str(theirs)])
    for i in range(3):
        sr, got = read_wav(mine / f"u{i}.wav")
        _, want = read_wav(theirs / f"u{i}.wav")
        assert sr == SR and got.dtype == np.int16 and got.shape == want.shape
        assert np.max(np.abs(got.astype(np.int32) - want.astype(np.int32))) <= 1


def test_denoise_cli_refuses_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        denoise.main(["-i", str(tmp_path), "-o", str(tmp_path / "o")])


def test_build_lexicon_matches_jax(tmp_path, capsys):
    words = tmp_path / "words.txt"
    words.write_text("Xin chào, thế giới!\nmột hai ba 12 người\nsil xin\n", encoding="utf-8")
    build_lexicon.main(["-i", str(words), "-o", str(tmp_path / "port.txt")])
    jax_build_lexicon.main(["-i", str(words), "-o", str(tmp_path / "jax.txt")])
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()
    out = capsys.readouterr().out.splitlines()
    assert out[0].replace("port.txt", "") == out[1].replace("jax.txt", "")


def _write_silent_wav(path, seconds=0.1):
    with wave_mod.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(np.zeros(int(SR * seconds), "<i2").tobytes())


@pytest.fixture
def raw_corpus(tmp_path):
    d = tmp_path / "raw"
    d.mkdir()
    _write_silent_wav(d / "utt1.wav")
    (d / "utt1.txt").write_text("Xin chào, thế giới!", encoding="utf-8")
    _write_silent_wav(d / "utt2.wav")
    (d / "utt2.lab").write_text("một hai ba", encoding="utf-8")
    _write_silent_wav(d / "orphan.wav")
    return d


FAKE_MFA = """#!{python}
import sys
from pathlib import Path
with open({log!r}, "a") as f:
    f.write("\\t".join(sys.argv[1:]) + "\\n")
out = Path(next(a for a in sys.argv[1:] if a.endswith("textgrids")))
(out / "speaker").mkdir(parents=True, exist_ok=True)
(out / "utt1.TextGrid").write_text("tg1")
(out / "speaker" / "utt2.TextGrid").write_text("tg2")
"""


@pytest.mark.parametrize("model", [None, "vietnamese_mfa"])
def test_align_matches_jax(raw_corpus, tmp_path, monkeypatch, model):
    """Both tools on the same corpus with a fake ``mfa`` on ``PATH``: the
    same corpus files, lexicon bytes, command lines (their directories
    aside) and collected outputs."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    log = tmp_path / "mfa.log"
    mfa = bindir / "mfa"
    mfa.write_text(FAKE_MFA.format(python=sys.executable, log=str(log)))
    mfa.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    extra = [] if model is None else ["--acoustic-model", model]
    runs = {}
    for name, tool in (("port", align), ("jax", jax_align)):
        work, out = tmp_path / f"work_{name}", tmp_path / f"out_{name}"
        assert tool.main(["-i", str(raw_corpus), "-o", str(out), "--work-dir", str(work), "--num-jobs", "3",
                          *extra, "--", "--beam", "100"]) == 0
        runs[name] = (work, out)
    lines = [line.split("\t") for line in log.read_text().splitlines()]
    assert len(lines) == 2
    port_cmd, jax_cmd = ([a.replace(str(tmp_path / f"work_{n}"), "WORK") for a in cmd]
                         for n, cmd in zip(("port", "jax"), lines))
    assert port_cmd == jax_cmd
    assert port_cmd[:4] == (["train", "--clean", "-j", "3"] if model is None else ["align", "--clean", "-j", "3"])
    assert port_cmd[-2:] == ["--beam", "100"]
    (pw, po), (jw, jo) = runs["port"], runs["jax"]
    for rel in ("corpus/utt1.lab", "corpus/utt2.lab", "lexicon.txt", "corpus/utt1.wav"):
        assert (pw / rel).read_bytes() == (jw / rel).read_bytes(), rel
    assert sorted(p.name for p in (pw / "corpus").iterdir()) == sorted(p.name for p in (jw / "corpus").iterdir())
    assert sorted(p.name for p in po.iterdir()) == sorted(p.name for p in jo.iterdir()) == [
        "utt1.TextGrid", "utt1.wav", "utt2.TextGrid", "utt2.wav"]


def test_align_missing_binary_message_matches_jax(raw_corpus, tmp_path):
    messages = []
    for name, tool in (("port", align), ("jax", jax_align)):
        with pytest.raises(SystemExit, match="not found") as e:
            tool.main(["-i", str(raw_corpus), "-o", str(tmp_path / f"o_{name}"), "--work-dir",
                       str(tmp_path / f"w_{name}"), "--mfa-binary", str(tmp_path / "definitely-not-mfa")])
        messages.append(str(e.value))
    assert messages[0] == messages[1]


def test_align_skip_mfa_and_lexicon_reuse(raw_corpus, tmp_path):
    lex = tmp_path / "given.txt"
    lex.write_text("xin\tx i n\n", encoding="utf-8")
    work = tmp_path / "work"
    assert align.main(["-i", str(raw_corpus), "-o", str(tmp_path / "o"), "--work-dir", str(work),
                       "--lexicon", str(lex), "--skip-mfa"]) == 0
    assert not (work / "lexicon.txt").exists()
    assert (work / "corpus" / "utt1.lab").read_text(encoding="utf-8") == "xin chào thế giới"


def test_trace_writes_only_when_asked(tmp_path, monkeypatch):
    monkeypatch.delenv(profiling.PROFILE_ENV, raising=False)
    with profiling.trace():
        torch.ones(4).sum()
    assert not any(tmp_path.iterdir())
    monkeypatch.setenv(profiling.PROFILE_ENV, str(tmp_path / "env"))
    with profiling.trace():
        with profiling.annotate("marked_region"):
            (torch.ones(8, 8) @ torch.ones(8, 8)).sum()
    traces = list((tmp_path / "env").glob("*.pt.trace.json"))
    assert len(traces) == 1 and "marked_region" in traces[0].read_text()
    with profiling.trace(tmp_path / "arg"):
        torch.ones(4).sum()
    assert len(list((tmp_path / "arg").glob("*.pt.trace.json"))) == 1
    timer = profiling.StepTimer("cpu")
    timer.tick(3)
    assert timer.steps_per_sec() > 0
    timer.reset()
    assert timer.steps_per_sec() == 0.0


def test_trainer_leaves_a_trace(tmp_path, monkeypatch):
    """The GAN trainer, 1 step at tiny widths on the CPU, with
    ``VIETTTS_PROFILE_DIR`` set."""
    from viettts_tpu_torch.train import hifigan

    wavs = tmp_path / "wavs"
    wavs.mkdir()
    for i in range(2):
        write_wav(wavs / f"u{i}.wav", _tone_plus_noise(i, seconds=0.2), SR)
    monkeypatch.setenv(profiling.PROFILE_ENV, str(tmp_path / "trace"))
    hifigan.main(["--wav-dir", str(wavs), "--ckpt-dir", str(tmp_path / "ckpt"), "--steps", "1", "--device", "cpu",
                  "--set", "train.batch_size=2", "--set", "hifigan.segment_size=512",
                  "--set", "hifigan.upsample_initial_channel=16", "--set", "hifigan.mpd_base_channels=4",
                  "--set", "hifigan.msd_scales=1", "--set", "hifigan.msd_base_channels=16"])
    traces = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(traces) == 1 and "gan_step" in traces[0].read_text()
    assert (tmp_path / "ckpt" / "hifigan_latest_ckpt.pickle").exists()


def test_trainers_parse_torchrun_environment(monkeypatch):
    """Without ``torchrun``'s environment the trainers keep ``--device``;
    with it they join the group (here: refused, no rendezvous address)."""
    from viettts_tpu_torch.train.common import launch_device

    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert launch_device("cpu") == "cpu"
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="torchrun's environment"):
        launch_device("cpu")


def test_tools_run_as_modules(tmp_path):
    """``python -m viettts_tpu_torch.tools.<name> --help`` for the three
    tools, with the JAX package unimportable."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    block = ("import sys\nclass B:\n    def find_spec(self, name, *a):\n"
             "        if name.split('.')[0] in ('jax', 'flax', 'optax', 'viettts_tpu'):\n"
             "            raise ImportError(name)\nsys.meta_path.insert(0, B())\n")
    for name in ("denoise", "align", "build_lexicon"):
        code = block + f"import runpy; sys.argv = ['x', '--help']; runpy.run_module('viettts_tpu_torch.tools.{name}', run_name='__main__')"
        out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr[-2000:]
        assert "usage:" in out.stdout
