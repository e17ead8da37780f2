"""The port's tools against the JAX package's, on the CPU: the silence
zeroing (bit-equal WAVs), the GTA export of a tiny acoustic checkpoint
(within 1e-5) and the upstream HiFi-GAN converter on seeded state dicts
(the same trees; the converted discriminators in the port's modules give
what upstream-style torch modules, ``spectral_norm`` included, give).

The corpus has the synthetic corpus's alignments over white noise.  A
float32 DFT resolves a bin only to about 1e-7 of the frame's largest:
on tonal audio the empty high bins sit at the log-mel clip (log 1e-5),
where any two float32 front ends part by up to 1e-2 (the front end's own
bar is ``test_torch_mel``'s).  On noise every bin is resolved, so the
GTA export, whose model agrees within 2e-6 on equal inputs, is held to
1e-5 end to end."""

import copy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn
from torch.nn import functional as F
from torch.nn.utils import spectral_norm, weight_norm

import jax

from viettts_tpu.config import AcousticModelConfig, Config, DataConfig
from viettts_tpu.tools import convert_torch_hifigan as jax_convert
from viettts_tpu.tools import gta as jax_gta
from viettts_tpu.tools import zero_silence_segments as jax_zero
from viettts_tpu.train import checkpoint as jax_ckpt
from viettts_tpu_torch import checkpoint as ckpt
from viettts_tpu_torch.audio import read_wav, write_wav
from viettts_tpu_torch.models.discriminators import Discriminators
from viettts_tpu_torch.tools import convert_torch_hifigan as port_convert
from viettts_tpu_torch.tools import gta as port_gta
from viettts_tpu_torch.tools import zero_silence_segments as port_zero

from test_torch_checkpoint import _flat
from test_torch_pipeline import port_config
from test_torch_train import _variables

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        from validate_e2e_training import build_corpus
    finally:
        sys.path.remove(str(REPO / "scripts"))
    d = tmp_path_factory.mktemp("corpus")
    build_corpus(d, n_utts=6, seed=1)
    rng = np.random.RandomState(1)
    for wav in sorted(d.glob("*.wav")):
        sr, y = read_wav(wav)
        write_wav(wav, (rng.randn(len(y)) * 3000).astype(np.int16), sr)
    return d


def test_zero_silence_writes_jax_bytes(corpus, tmp_path):
    jax_zero.main(["-i", str(corpus), "-o", str(tmp_path / "jax")])
    port_zero.main(["-i", str(corpus), "-o", str(tmp_path / "port")])
    want = sorted((tmp_path / "jax").glob("*.wav"))
    assert len(want) == 6
    for w in want:
        assert (tmp_path / "port" / w.name).read_bytes() == w.read_bytes(), w.name
    assert (tmp_path / "port" / want[0].name).read_bytes() != (corpus / want[0].name).read_bytes()


def test_gta_export_matches_jax(corpus, tmp_path):
    """Both exports from one seeded acoustic checkpoint (prenet dropout
    off at inference, so both are deterministic): the same files, shapes
    [mel_dim, wav_len // hop] and values within 1e-5."""
    acoustic = AcousticModelConfig(encoder_dim=16, decoder_dim=32, prenet_dim=16, postnet_dim=16,
                                   prenet_dropout_at_inference=False)
    cfg = Config(acoustic=acoustic, data=DataConfig(max_phoneme_seq_len=64, max_wave_len=256 * 160),
                 data_dir=corpus, ckpt_dir=tmp_path)
    _, variables = _variables("acoustic", acoustic, seed=2)
    path = tmp_path / "acoustic_latest_ckpt.pickle"
    jax_ckpt.save_checkpoint(path, {"format": jax_ckpt.NATIVE_FORMAT, "step": 0, "variables": variables})
    n_jax = jax_gta.generate_gta(tmp_path / "jax", cfg)
    n_port = port_gta.generate_gta(tmp_path / "port", port_config(cfg), device="cpu")
    assert n_jax == n_port == 6
    for want_file in sorted((tmp_path / "jax").glob("*.npy")):
        want, got = np.load(want_file), np.load(tmp_path / "port" / want_file.name)
        assert got.shape == want.shape and want.shape[0] == 80
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()), err_msg=want_file.name)


def test_gta_entry_point_without_cuda_fails(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_gta.main(["-o", str(tmp_path), "--data-dir", str(corpus), "--ckpt-dir", str(tmp_path)])


# ---------------------------------------------------------------------------
# The upstream converter on seeded state dicts.
# ---------------------------------------------------------------------------


def _generator_state_dict(seed):
    """An upstream generator's state dict at tiny widths (weight-normalized
    convs, ``weight_g`` over dim 0 as torch's ``weight_norm`` keeps it)."""
    rng = np.random.RandomState(seed)
    sd = {}

    def wn(name, shape):
        sd[f"{name}.weight_v"] = torch.from_numpy(rng.randn(*shape).astype(np.float32))
        sd[f"{name}.weight_g"] = torch.from_numpy(np.abs(rng.randn(shape[0], 1, 1)).astype(np.float32))
        sd[f"{name}.bias"] = torch.from_numpy(rng.randn(shape[1] if name.startswith("ups") else shape[0])
                                              .astype(np.float32))

    wn("conv_pre", (16, 80, 7))
    for i, (c_in, c_out, k) in enumerate(((16, 8, 16), (8, 4, 16))):
        wn(f"ups.{i}", (c_in, c_out, k))
        for j in range(2):
            wn(f"resblocks.{i}.convs1.{j}", (c_out, c_out, 3))
            wn(f"resblocks.{i}.convs2.{j}", (c_out, c_out, 3))
    wn("conv_post", (1, 4, 7))
    return sd


def test_convert_state_dict_matches_jax():
    sd = _generator_state_dict(3)
    got, want = port_convert.convert_state_dict(sd), jax_convert.convert_state_dict(sd)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, g), w in zip(jax.tree_util.tree_flatten_with_path(got)[0], jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))


class _DiscP(nn.Module):
    """Upstream DiscriminatorP at 1/8 width."""

    def __init__(self, period):
        super().__init__()
        self.period = period
        chans = [(1, 4), (4, 16), (16, 64), (64, 128), (128, 128)]
        self.convs = nn.ModuleList(weight_norm(nn.Conv2d(i, o, (5, 1), (3, 1) if j < 4 else 1, padding=(2, 0)))
                                   for j, (i, o) in enumerate(chans))
        self.conv_post = weight_norm(nn.Conv2d(128, 1, (3, 1), 1, padding=(1, 0)))

    def forward(self, x):
        b, c, t = x.shape
        if t % self.period:
            x = F.pad(x, (0, self.period - t % self.period), "reflect")
            t = x.shape[-1]
        x = x.view(b, c, t // self.period, self.period)
        for layer in self.convs:
            x = F.leaky_relu(layer(x), 0.1)
        return torch.flatten(self.conv_post(x), 1, -1)


class _DiscS(nn.Module):
    """Upstream DiscriminatorS at 1/8 width."""

    def __init__(self, use_sn):
        super().__init__()
        norm = spectral_norm if use_sn else weight_norm
        specs = [(1, 16, 15, 1, 1, 7), (16, 16, 41, 2, 4, 20), (16, 32, 41, 2, 16, 20), (32, 64, 41, 4, 16, 20),
                 (64, 128, 41, 4, 16, 20), (128, 128, 41, 1, 16, 20), (128, 128, 5, 1, 1, 2)]
        self.convs = nn.ModuleList(norm(nn.Conv1d(i, o, k, s, groups=g, padding=p)) for i, o, k, s, g, p in specs)
        self.conv_post = norm(nn.Conv1d(128, 1, 3, 1, padding=1))

    def forward(self, x):
        for layer in self.convs:
            x = F.leaky_relu(layer(x), 0.1)
        return torch.flatten(self.conv_post(x), 1, -1)


class _Stack(nn.Module):
    def __init__(self, discs):
        super().__init__()
        self.discriminators = nn.ModuleList(discs)


PERIODS = (2, 3, 5, 7, 11)


def _upstream_discriminators(seed):
    torch.manual_seed(seed)
    return _Stack([_DiscP(p) for p in PERIODS]), _Stack([_DiscS(i == 0) for i in range(3)])


def test_convert_discriminators_matches_jax_and_upstream():
    """The converted trees equal JAX's; loaded into the port's
    discriminators they give the upstream modules' train-mode outputs
    (torch's ``spectral_norm`` takes one power-iteration step from the
    stored ``u``, as the port's spectral step does)."""
    mpd, msd = _upstream_discriminators(4)
    mpd_sd, msd_sd = copy.deepcopy(mpd.state_dict()), copy.deepcopy(msd.state_dict())
    got, want = port_convert.convert_discriminators(mpd_sd, msd_sd), jax_convert.convert_discriminators(mpd_sd, msd_sd)
    for g_tree, w_tree in zip(got, want):
        assert jax.tree.structure(g_tree) == jax.tree.structure(w_tree)
        for g, w in zip(jax.tree.leaves(g_tree), jax.tree.leaves(w_tree)):
            np.testing.assert_array_equal(g, w)

    disc_params, spectral = got
    discs = Discriminators(PERIODS, 4, 3, 16)
    named = dict(discs.named_parameters())
    with torch.no_grad():
        for k, a in ckpt.named_from_gan_tree(disc_params, list(named)).items():
            named[k].copy_(torch.from_numpy(a))
    u = {k: torch.from_numpy(a) for k, a in ckpt.named_from_gan_tree(spectral, discs.spectral_names()).items()}
    wave = torch.from_numpy((np.random.RandomState(5).randn(2, 1, 1000) * 0.1).astype(np.float32))
    with torch.no_grad():
        mpd_out, msd_out, _ = discs(wave, wave, u, update_stats=False)
        want_p = [d(wave) for d in mpd.discriminators]
        x, want_s = wave, []
        for i, d in enumerate(msd.discriminators):
            if i:
                x = F.avg_pool1d(x, 4, 2, padding=2)
            want_s.append(d(x))
    for g, w in zip(mpd_out[0] + msd_out[0], want_p + want_s):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=2e-5)


def test_convert_entry_point_writes_native_pickles(tmp_path):
    """``main`` on saved ``g_*`` / ``do_*`` files: JAX's loaders read what
    it writes, and it holds JAX's converted trees."""
    g_file, do_file = tmp_path / "g_00000001", tmp_path / "do_00000001"
    sd = _generator_state_dict(6)
    torch.save({"generator": sd}, g_file)
    mpd, msd = _upstream_discriminators(7)
    torch.save({"mpd": mpd.state_dict(), "msd": msd.state_dict(), "steps": 1234}, do_file)
    out = tmp_path / "out" / "hifigan_latest_ckpt.pickle"
    port_convert.main(["--checkpoint-file", str(g_file), "--output-file", str(out), "--do-file", str(do_file)])
    got = _flat(jax_ckpt.load_variables(out, "hifigan"))
    want = _flat(jax_convert.convert_state_dict(sd))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    disc = jax_ckpt.load_checkpoint(out.parent / "hifigan_disc_ckpt.pickle")
    assert disc["step"] == 1234
    want_d, want_s = jax_convert.convert_discriminators(mpd.state_dict(), msd.state_dict())
    for g_tree, w_tree in ((disc["disc_params"], want_d), (disc["spectral"], want_s)):
        g, w = _flat(g_tree), _flat(w_tree)
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
