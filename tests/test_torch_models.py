"""PyTorch port of the models against the JAX modules, at small widths.

Each JAX variable tree is randomized with numpy from a seed (so batch
statistics and biases are not trivially zero), converted to numpy, copied
into the port's modules through the checkpoint bridge, and both sides run
the same inputs on the CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from viettts_tpu.config import AcousticModelConfig, DurationModelConfig, HifiGanConfig
from viettts_tpu.models import AcousticModel, DurationModel, Generator
from viettts_tpu.models.encoder import TokenEncoder
from viettts_tpu.models.hifigan import generator_apply_fused
from viettts_tpu.types import AcousticBatch
from viettts_tpu.types import DurationBatch as JaxDurationBatch
from viettts_tpu_torch import checkpoint as ckpt
from viettts_tpu_torch.models.acoustic import AcousticModel as TorchAcoustic
from viettts_tpu_torch.models.duration import DurationModel as TorchDuration
from viettts_tpu_torch.models.encoder import TokenEncoder as TorchEncoder
from viettts_tpu_torch.models.hifigan import Generator as TorchGenerator
from viettts_tpu_torch.models.hifigan import generator_apply_fused as torch_apply_fused
from viettts_tpu_torch.types import DurationBatch

VOCAB = 40


def _randomize(tree, rng, scale=0.3):
    """Seeded noise in place of every leaf of a shape tree (from
    ``jax.eval_shape``); BatchNorm variances stay positive."""

    def walk(node, key=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(v, f) for f, v in zip(node._fields, node)))
        noise = (rng.randn(*node.shape) * scale).astype(np.float32)
        if key == "var":
            return np.abs(noise) + 0.5
        return noise

    return walk(tree)


def _shapes(module, *args, **kwargs):
    return dict(jax.eval_shape(lambda: module.init(*args, **kwargs)))


def _tokens(rng, B, T, lengths):
    toks = rng.randint(1, VOCAB, (B, T)).astype(np.int64)
    for i, n in enumerate(lengths):
        toks[i, n:] = 0
    return toks


def test_encoder_matches_jax():
    rng = np.random.RandomState(0)
    B, T, C = 2, 9, 16
    lengths = np.asarray([9, 5])
    toks = _tokens(rng, B, T, lengths)
    enc = TokenEncoder(vocab_size=VOCAB, lstm_dim=C, dropout_rate=0.5)
    variables = _randomize(_shapes(enc, jax.random.PRNGKey(0), jnp.asarray(toks), jnp.asarray(lengths), train=False), rng)
    want = np.asarray(enc.apply(variables, jnp.asarray(toks), jnp.asarray(lengths), train=False))

    port = TorchEncoder(VOCAB, C)
    ckpt._put_encoder(port, variables["params"], variables["batch_stats"])
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(toks), torch.from_numpy(lengths)).numpy()
    for i, n in enumerate(lengths):
        np.testing.assert_allclose(got[i, :n], want[i, :n], atol=1e-5)


def test_duration_model_matches_jax():
    rng = np.random.RandomState(1)
    cfg = DurationModelConfig(vocab_size=VOCAB, lstm_dim=16)
    B, T = 2, 12
    lengths = np.asarray([12, 7])
    toks = _tokens(rng, B, T, lengths)
    model = DurationModel(cfg)
    jbatch = JaxDurationBatch(jnp.asarray(toks), jnp.asarray(lengths), None)
    variables = _randomize(_shapes(model, jax.random.PRNGKey(0), jbatch, train=False), rng)
    want = np.asarray(model.apply(variables, jbatch, train=False))

    port = TorchDuration(cfg)
    ckpt.load_duration(port, variables)
    with torch.no_grad():
        got = port.eval()(
            DurationBatch(torch.from_numpy(toks), torch.from_numpy(lengths), None)
        ).numpy()
    for i, n in enumerate(lengths):
        np.testing.assert_allclose(got[i, :n], want[i, :n], atol=1e-5)


def test_acoustic_inference_matches_jax():
    """Dropout off; the JAX side takes its plain lax.scan decode.  Mel
    tolerance 1e-4: a 48-frame recurrence compounds float32 rounding of
    differently ordered sums."""
    rng = np.random.RandomState(2)
    cfg = AcousticModelConfig(
        vocab_size=VOCAB, encoder_dim=16, decoder_dim=16, prenet_dim=8,
        postnet_dim=8, prenet_dropout_at_inference=False,
    )
    B, T, NF = 2, 8, 48
    lengths = np.asarray([8, 5])
    toks = _tokens(rng, B, T, lengths)
    durs = (rng.rand(B, T) * 4 + 1).astype(np.float32)
    durs[1, 5:] = 0.0
    model = AcousticModel(cfg)
    batch = AcousticBatch(
        jnp.asarray(toks), jnp.asarray(lengths), jnp.asarray(durs), None, None,
        jnp.zeros((B, NF, 80)),
    )
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("params", "dropout", "prenet", "zoneout"))}
    variables = _randomize(_shapes(model, rngs, batch, train=True), rng, scale=0.2)
    want = np.asarray(
        model.apply(
            variables, jnp.asarray(toks), jnp.asarray(durs), NF, jnp.asarray(lengths),
            use_pallas=False, method=AcousticModel.inference,
        )
    )

    port = TorchAcoustic(cfg)
    ckpt.load_acoustic(port, variables)
    with torch.no_grad():
        got = port.eval().inference(
            torch.from_numpy(toks), torch.from_numpy(durs), NF, torch.from_numpy(lengths)
        ).numpy()
    assert got.shape == want.shape == (B, NF, 80)
    np.testing.assert_allclose(got, want, atol=1e-4)


def _hifigan_cfg(resblock="1"):
    return HifiGanConfig(
        resblock=resblock,
        upsample_rates=(8, 8, 2, 2),
        upsample_kernel_sizes=(16, 16, 4, 4),
        upsample_initial_channel=32,  # stages: 16, 8, 4, 2 channels
        resblock_kernel_sizes=(3, 7),
        resblock_dilation_sizes=((1, 3, 5), (1, 3)),
    )


def _generator(cfg, seed, T=6):
    rng = np.random.RandomState(seed)
    mel = rng.randn(2, T, 80).astype(np.float32)
    gen = Generator(cfg)
    variables = _randomize(_shapes(gen, jax.random.PRNGKey(0), jnp.asarray(mel)), rng, scale=0.15)
    port = TorchGenerator(cfg)
    ckpt.load_generator(port, variables)
    return gen, variables, port.eval(), mel


@pytest.mark.parametrize("resblock", ["1", "2"])
def test_generator_f32_matches_jax(resblock):
    """Plain float32 generator (torch convs) against ``Generator.apply``:
    1e-5 absolute, float32 on both sides."""
    cfg = _hifigan_cfg(resblock)
    gen, variables, port, mel = _generator(cfg, seed=3)
    want = np.asarray(gen.apply(variables, jnp.asarray(mel)))
    with torch.no_grad():
        got = port(torch.from_numpy(mel)).numpy()
        fused = torch_apply_fused(port, torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (2, 6 * 256, 1)
    np.testing.assert_allclose(got, want, atol=1e-5)
    # the serving route (fused_mrf stages) in float32 is the same function
    np.testing.assert_allclose(fused, want, atol=1e-5)


def test_generator_bf16_route_matches_jax_fused():
    """bf16 storage route against JAX ``generator_apply_fused(bf16)`` with
    the Pallas kernel in interpret mode.  0.02 absolute, the bar of
    tests/test_mrf.py for bf16 storage: the two sides round to bf16 at
    slightly different points (JAX's conv_pre emits bf16 after its bias)."""
    cfg = _hifigan_cfg()
    _, variables, port, mel = _generator(cfg, seed=4, T=4)
    want = np.asarray(
        generator_apply_fused(
            cfg, variables["params"], jnp.asarray(mel),
            compute_dtype=jnp.bfloat16, interpret=True,
        )
    )
    with torch.no_grad():
        got = torch_apply_fused(port, torch.from_numpy(mel), torch.bfloat16).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=0.02)
