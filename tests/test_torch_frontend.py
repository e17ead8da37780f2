"""The port's own copies of the JAX package's framework-free modules (text
front end, config tree, WAV writing) against the originals, and a guard
that no module of the port imports jax or the JAX package."""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

import viettts_tpu.config as jax_config
import viettts_tpu.serve as jax_serve
import viettts_tpu.text as jax_text
from viettts_tpu.data.audio import write_wav as jax_write_wav
from viettts_tpu_torch import audio, config, serve, text

REPO = Path(__file__).resolve().parents[1]

SENTENCES = [
    "xin chào các bạn, hôm nay trời đẹp quá",
    "Hôm Qua EM TỚI TRƯỜNG!",  # mixed case
    "số 1.234.567 và 3,5 kg; năm 2024",  # grouped thousands, decimal comma, plain
    "gọi 0987654321 hoặc 12.34 hay 3.5",  # leading zero, odd groupings
    'anh ấy nói: "được rồi"... thật không?',  # quotes, ellipsis, punctuation runs
    "hello world zzz qwf",  # unknown words, letters outside the phoneme set
    "  nhiều   khoảng\ttrắng\nvà dòng mới  ",  # whitespace and newlines
    "ﬁ１２ thứ Ⅻ",  # NFKC: ligature, full-width digits, roman numeral
    "",
    "-5 độ, 1000000000000000000 và 100 phần trăm",
]


@pytest.mark.parametrize("sentence", SENTENCES)
def test_normalize_and_tokens_match_jax(sentence):
    want = jax_text.normalize_text(sentence)
    assert text.normalize_text(sentence) == want
    assert text.normalize_text(sentence, numbers=False) == jax_text.normalize_text(sentence, numbers=False)
    assert text.text_to_tokens(want) == jax_text.text_to_tokens(want)


@pytest.mark.parametrize("n", [0, 5, 15, 21, 105, 1002, 1_000_005, 10**18, -7])
def test_number_reading_matches_jax(n):
    assert text.number_to_vietnamese(n) == jax_text.number_to_vietnamese(n)


def test_lexicon_tokens_match_jax(tmp_path):
    lex = tmp_path / "lexicon.txt"
    lex.write_text("Xin\tx i n\nchào\tc h à o\n\nbạn\tb ạ n\n", encoding="utf-8")
    got, want = text.load_lexicon(lex), jax_text.load_lexicon(lex)
    assert got == want and got["xin"] == "x i n"
    for s in SENTENCES[:3]:
        norm = text.normalize_text(s)
        assert text.text_to_tokens(norm, got) == jax_text.text_to_tokens(norm, want)
    assert text.tokens_to_ids(["sil", "a", " "]) == jax_text.tokens_to_ids(["sil", "a", " "])


def test_phoneme_abi_matches_jax():
    assert config.ALL_PHONEMES == jax_config.ALL_PHONEMES
    assert (config.SIL_INDEX, config.WORD_END_INDEX) == (jax_config.SIL_INDEX, jax_config.WORD_END_INDEX)


def test_config_defaults_match_jax():
    got, want = config.Config(), jax_config.Config()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    for section in ("dsp", "duration", "acoustic", "hifigan", "train", "data"):
        assert type(getattr(got, section)).__name__ == type(getattr(want, section)).__name__
    assert got.dsp.frames_per_second == want.dsp.frames_per_second
    assert got.hifigan.total_upsample == want.hifigan.total_upsample


@pytest.mark.parametrize(
    "overrides",
    [
        ["hifigan.inference_dtype=int8"],
        ["--acoustic.prenet_dropout_at_inference=false", "train.batch_size=32"],
        ["hifigan.upsample_rates=(4,4,4)", "dsp.fmax=7600.5"],
        ["ckpt_dir=/tmp/ckpts", "data.max_phoneme_seq_len=16"],
        ["train.mixed_precision=yes", "hifigan.resblock_dilation_sizes=[1,3]"],
    ],
)
def test_apply_overrides_matches_jax(overrides):
    got = config.apply_overrides(config.Config(), overrides)
    want = jax_config.apply_overrides(jax_config.Config(), overrides)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("bad", ["no_equals_sign", "a.b.c=1"])
def test_apply_overrides_refuses_like_jax(bad):
    with pytest.raises(ValueError) as got:
        config.apply_overrides(config.Config(), [bad])
    with pytest.raises(ValueError) as want:
        jax_config.apply_overrides(jax_config.Config(), [bad])
    assert str(got.value) == str(want.value)


def test_hifigan_from_json_matches_jax(tmp_path):
    path = tmp_path / "config.json"
    path.write_text(
        '{"resblock": "2", "upsample_rates": [8, 8, 4], "upsample_kernel_sizes": [16, 16, 8],'
        ' "upsample_initial_channel": 256, "resblock_kernel_sizes": [3, 5],'
        ' "resblock_dilation_sizes": [[1, 2], [2, 6]], "num_mels": 80, "learning_rate": 1e-4}'
    )
    got, want = config.HifiGanConfig.from_json(path), jax_config.HifiGanConfig.from_json(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


_WAVES = {
    "float32": lambda rng: (rng.standard_normal(4000) * 0.7).astype(np.float32),
    "float64": lambda rng: rng.uniform(-1.5, 1.5, 3001),
    "int16": lambda rng: rng.integers(-32768, 32767, 999, dtype=np.int16),
    "int32": lambda rng: rng.integers(-2000, 2000, 512, dtype=np.int32),
}


@pytest.mark.parametrize("kind", sorted(_WAVES))
def test_write_wav_bytes_match_jax(kind, tmp_path):
    data = _WAVES[kind](np.random.default_rng(0))
    audio.write_wav(tmp_path / "port.wav", data, 16000)
    jax_write_wav(tmp_path / "jax.wav", data, 16000)
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()


@pytest.mark.parametrize("kind", ["float32", "float64"])
def test_wav_bytes_match_jax_server(kind):
    data = _WAVES[kind](np.random.default_rng(1))
    assert serve.wav_bytes(data, 22050) == jax_serve.wav_bytes(data, 22050)


def _imported_roots(path: Path):
    """(line, top-level module) of every import statement in a file."""
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module


def _port_files():
    return sorted((REPO / "viettts_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "scripts" / "profile_torch_synthesis.py",
        REPO / "scripts" / "probe_conv_pipeline.py", REPO / "scripts" / "stream_first_audio.py",
        REPO / "scripts" / "profile_torch_training.py", REPO / "scripts" / "time_vocoder_stages.py",
        REPO / "scripts" / "time_ar_decode.py",
    ]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    """Every module of the port, the chip smoke script and the port's
    profiling scripts: no statement
    imports jax, jaxlib, flax, optax or ``viettts_tpu`` (the
    ``viettts_tpu_torch`` package itself excepted), at any depth."""
    forbidden = {"jax", "jaxlib", "flax", "optax", "viettts_tpu"}
    bad = [(line, name) for line, name in _imported_roots(path) if name.split(".")[0] in forbidden]
    assert bad == []
