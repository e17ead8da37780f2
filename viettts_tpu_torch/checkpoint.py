"""Checkpoint reading and the weight bridge (counterpart of the load side of
``viettts_tpu/train/checkpoint.py`` and ``models/hifigan.py::fold_weight_norm``).

Everything here is numpy until the bridge copies a tree into a module:

* ``load_variables`` reads a native ``viettts_tpu/v1`` pickle or one of the
  three reference haiku pickles and returns the JAX package's variable
  tree ({"params": ..., "batch_stats": ...}) with numpy leaves.  Native
  pickles name the JAX package's ``LSTMParams`` class and, in training
  checkpoints, optax's optimizer-state classes; ``_PortUnpickler`` maps
  them to this module's NamedTuples (``JAX_GLOBALS``), so reading never
  imports jax or optax.
* ``load_duration`` / ``load_acoustic`` / ``load_generator`` copy such a
  tree into the port's modules, converting layouts: conv kernels
  (W, I, O) -> (O, I, W); ConvTranspose (W, I, O) -> (I, O, W) mirrored on
  W; dense kernels [in, out] -> ``nn.Linear`` [out, in]; LSTMs keep the
  fused JAX layout.  ``jax_location`` names the place of every tensor of
  the duration and acoustic modules in that tree, and ``jax_tree`` /
  ``named_from_jax`` convert both ways (the trainers' checkpoints).
* ``gan_tree`` / ``named_from_gan_tree`` do the same for the GAN
  trainer's trees: the weight-normalized generator's ``{v, g, bias}``,
  the discriminators' ``{"mpd": ..., "msd": ...}`` and the spectral
  state, Conv2d kernels (O, I, kh, kw) -> (kh, kw, I, O).
"""

from __future__ import annotations

import pickle
import re
from pathlib import Path
from typing import Any, Dict, Mapping, NamedTuple, Sequence, Tuple

import numpy as np
import torch

NATIVE_FORMAT = "viettts_tpu/v1"


class LSTMParams(NamedTuple):
    """numpy stand-in for ``viettts_tpu.ops.rnn.LSTMParams`` (same fields)."""

    w_i: np.ndarray  # [D, 4H]
    w_h: np.ndarray  # [H, 4H]
    b: np.ndarray  # [4H]


# Stand-ins for the optax states of the JAX trainers' optimizer,
# ``chain(clip_by_global_norm, adamw)``: its state is (EmptyState(),
# (ScaleByAdamState(count, mu, nu), EmptyState(), EmptyState() or, with a
# learning-rate schedule, ScaleByScheduleState(count))).


class EmptyState(NamedTuple):
    """optax's empty state (clipping, weight decay, a constant scale)."""


class ScaleByAdamState(NamedTuple):
    count: Any  # int32 scalar: updates taken
    mu: Any  # first moments, a tree like the params
    nu: Any  # second moments


class ScaleByScheduleState(NamedTuple):
    count: Any  # int32 scalar: schedule steps taken


# the global each stand-in is pickled under, as the JAX package pickles it
JAX_GLOBALS = {
    LSTMParams: ("viettts_tpu.ops.rnn", "LSTMParams"),
    EmptyState: ("optax._src.base", "EmptyState"),
    ScaleByAdamState: ("optax._src.transform", "ScaleByAdamState"),
    ScaleByScheduleState: ("optax._src.transform", "ScaleByScheduleState"),
}
_OPTAX_BY_NAME = {cls.__name__: cls for cls, (module, _) in JAX_GLOBALS.items() if module.startswith("optax")}


class _Opaque(tuple):
    """Inert stand-in for any other optax state class: the port reads the
    optimizer state of its own trainers' optimizer only."""

    def __new__(cls, *args):
        return tuple.__new__(cls, args)


class _PortUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if (module, name) == ("viettts_tpu.ops.rnn", "LSTMParams"):
            return LSTMParams
        root = module.split(".")[0]
        if root == "optax":
            return _OPTAX_BY_NAME.get(name, _Opaque)
        if root in ("jax", "jaxlib", "flax", "viettts_tpu"):
            raise pickle.UnpicklingError(
                f"checkpoint holds {module}.{name}, which the torch port cannot "
                "read without jax"
            )
        return super().find_class(module, name)


def load_pickle(path: str | Path) -> Any:
    with open(path, "rb") as f:
        return _PortUnpickler(f).load()


# ---------------------------------------------------------------------------
# Reference (haiku) checkpoint converters, mirroring the JAX package's key map.
# ---------------------------------------------------------------------------


def _split_lstm(linear: Dict[str, np.ndarray]) -> LSTMParams:
    """Split haiku's fused concat([x, h]) weight into (w_i, w_h)."""
    w = np.asarray(linear["w"])
    hidden = w.shape[1] // 4
    input_dim = w.shape[0] - hidden
    return LSTMParams(w_i=w[:input_dim], w_h=w[input_dim:], b=np.asarray(linear["b"]))


def _conv(entry) -> Dict[str, np.ndarray]:
    return {"kernel": np.asarray(entry["w"]), "bias": np.asarray(entry["b"])}


def _bn_params(entry) -> Dict[str, np.ndarray]:
    return {
        "scale": np.asarray(entry["scale"]).reshape(-1),
        "bias": np.asarray(entry["offset"]).reshape(-1),
    }


def _bn_stats(state, prefix: str) -> Dict[str, np.ndarray]:
    return {
        "mean": np.asarray(state[f"{prefix}/~/mean_ema"]["average"]).reshape(-1),
        "var": np.asarray(state[f"{prefix}/~/var_ema"]["average"]).reshape(-1),
    }


def _suffixed(base: str, i: int) -> str:
    return base if i == 0 else f"{base}_{i}"


def _convert_token_encoder(hk_params, hk_state, scope: str):
    p = {"embed": {"embedding": np.asarray(hk_params[f"{scope}/~/embed"]["embeddings"])}}
    s = {}
    for i in range(3):
        bn = f"{scope}/~/{_suffixed('batch_norm', i)}"
        p[f"conv_{i}"] = _conv(hk_params[f"{scope}/~/{_suffixed('conv1_d', i)}"])
        p[f"bn_{i}"] = _bn_params(hk_params[bn])
        s[f"bn_{i}"] = _bn_stats(hk_state, bn)
    p["lstm_fwd"] = _split_lstm(hk_params[f"{scope}/~/lstm/linear"])
    p["lstm_bwd"] = _split_lstm(hk_params[f"{scope}/~/lstm_1/linear"])
    return p, s


def _dense(entry) -> Dict[str, np.ndarray]:
    return {"kernel": np.asarray(entry["w"]), "bias": np.asarray(entry["b"])}


def convert_haiku_duration(hk_params, hk_state) -> Dict[str, Any]:
    root = "duration_model"
    enc_p, enc_s = _convert_token_encoder(hk_params, hk_state, f"{root}/~/token_encoder")
    params = {
        "encoder": enc_p,
        "proj_0": _dense(hk_params[f"{root}/~/linear"]),
        "proj_1": _dense(hk_params[f"{root}/~/linear_1"]),
    }
    return {"params": params, "batch_stats": {"encoder": enc_s}}


def convert_haiku_acoustic(hk_params, hk_state) -> Dict[str, Any]:
    root = "acoustic_model"
    enc_p, enc_s = _convert_token_encoder(hk_params, hk_state, f"{root}/~/token_encoder")
    params: Dict[str, Any] = {
        "encoder": enc_p,
        "decoder_lstm1": _split_lstm(hk_params[f"{root}/~/lstm/linear"]),
        "decoder_lstm2": _split_lstm(hk_params[f"{root}/~/lstm_1/linear"]),
        "projection": _dense(hk_params[f"{root}/~/linear"]),
        "prenet_fc1": {"kernel": np.asarray(hk_params[f"{root}/~/linear_1"]["w"])},
        "prenet_fc2": {"kernel": np.asarray(hk_params[f"{root}/~/linear_2"]["w"])},
    }
    stats: Dict[str, Any] = {"encoder": enc_s}
    for i in range(5):
        params[f"postnet_conv_{i}"] = _conv(hk_params[f"{root}/~/{_suffixed('conv1_d', i)}"])
    for i in range(4):
        bn = f"{root}/~/{_suffixed('batch_norm', i)}"
        params[f"postnet_bn_{i}"] = _bn_params(hk_params[bn])
        stats[f"postnet_bn_{i}"] = _bn_stats(hk_state, bn)
    return {"params": params, "batch_stats": stats}


def convert_haiku_hifigan(
    flat,
    num_upsamples: int = 4,
    num_resblocks: int = 12,
    resblock_convs: int = 3,
    resblock_version: str = "1",
) -> Dict[str, Any]:
    """``hk_hifi.pickle`` -> generator params.  Haiku ConvTranspose kernels
    are (W, O, I); the JAX package's are (W, I, O)."""
    params: Dict[str, Any] = {
        "conv_pre": _conv(flat["generator/~/conv1_d"]),
        "conv_post": _conv(flat["generator/~/conv1_d_1"]),
    }
    for i in range(num_upsamples):
        entry = flat[f"generator/~/ups_{i}"]
        params[f"ups_{i}"] = {
            "kernel": np.swapaxes(np.asarray(entry["w"]), 1, 2),
            "bias": np.asarray(entry["b"]),
        }
    for r in range(num_resblocks):
        scope = f"generator/~/res_block{resblock_version}_{r}"
        names = (
            [f"convs1_{j}" for j in range(resblock_convs)]
            + [f"convs2_{j}" for j in range(resblock_convs)]
            if resblock_version == "1"
            else [f"convs_{j}" for j in range(resblock_convs)]
        )
        params[f"resblock_{r}"] = {n: _conv(flat[f"{scope}/~/{n}"]) for n in names}
    return {"params": params}


def fold_weight_norm(params):
    """Fold ``{v, g}`` weight-normalized kernels into plain ``kernel``s."""
    if not isinstance(params, dict):
        return params
    if "v" in params and "g" in params:
        v, g = np.asarray(params["v"]), np.asarray(params["g"])
        norm = np.linalg.norm(v.reshape(-1, v.shape[-1]), axis=0)
        out = {k: x for k, x in params.items() if k not in ("v", "g")}
        out["kernel"] = v * (g / np.maximum(norm, 1e-12))
        return out
    return {k: fold_weight_norm(x) for k, x in params.items()}


def load_variables(path: str | Path, kind: str) -> Dict[str, Any]:
    """Read a native or reference checkpoint -> numpy variable tree.

    kind: 'duration' | 'acoustic' | 'hifigan'.
    """
    dic = load_pickle(path)
    if isinstance(dic, dict) and dic.get("format") == NATIVE_FORMAT:
        return dic["variables"]
    if kind == "duration":
        return convert_haiku_duration(dic["params"], dic["aux"])
    if kind == "acoustic":
        return convert_haiku_acoustic(dic["params"], dic["aux"])
    if kind == "hifigan":
        return convert_haiku_hifigan(dic)
    raise ValueError(f"unknown checkpoint kind {kind!r}")


# ---------------------------------------------------------------------------
# Layout map of the duration and acoustic modules.
# ---------------------------------------------------------------------------

# (port tensor name, collection, JAX path with "/" or "." between keys,
# layout): "conv" kernels are (O, I, W) here and (W, I, O) there, "dense"
# ``nn.Linear`` weights [out, in] here and [in, out] there; both are their
# own inverse.  The acoustic model keeps its dense kernels in the JAX layout.
_LAYOUT: Tuple[Tuple[str, str, str, Any], ...] = (
    (r"(encoder\.)embed\.weight", "params", r"\1embed/embedding", None),
    (r"(encoder\.c|postnet_c)onvs\.(\d)\.weight", "params", r"\1onv_\2/kernel", "conv"),
    (r"(encoder\.c|postnet_c)onvs\.(\d)\.bias", "params", r"\1onv_\2/bias", None),
    (r"(encoder\.b|postnet_b)ns\.(\d)\.weight", "params", r"\1n_\2/scale", None),
    (r"(encoder\.b|postnet_b)ns\.(\d)\.bias", "params", r"\1n_\2/bias", None),
    (r"(encoder\.b|postnet_b)ns\.(\d)\.running_mean", "batch_stats", r"\1n_\2/mean", None),
    (r"(encoder\.b|postnet_b)ns\.(\d)\.running_var", "batch_stats", r"\1n_\2/var", None),
    (r"(encoder\.lstm_fwd|encoder\.lstm_bwd)\.(w_i|w_h|b)", "params", r"\1/\2", None),
    (r"lstm([12])\.(w_i|w_h|b)", "params", r"decoder_lstm\1/\2", None),
    (r"(proj_[01])\.weight", "params", r"\1/kernel", "dense"),
    (r"(proj_[01])\.bias", "params", r"\1/bias", None),
    (r"(prenet_fc[12])", "params", r"\1/kernel", None),
    (r"proj_kernel", "params", "projection/kernel", None),
    (r"proj_bias", "params", "projection/bias", None),
)


def jax_location(name: str) -> Tuple[str, Tuple[str, ...], Any]:
    """(collection, path, layout) in the JAX package's variable tree of a
    duration or acoustic module's parameter or statistic ``name``."""
    for pattern, collection, template, layout in _LAYOUT:
        m = re.fullmatch(pattern, name)
        if m:
            return collection, tuple(m.expand(template).replace(".", "/").split("/")), layout
    raise KeyError(f"no JAX counterpart for {name!r}")


def _relayout(a, layout):
    """Between the port's layout and the JAX one (each is its own inverse)."""
    if layout == "conv":
        return a.permute(2, 1, 0) if isinstance(a, torch.Tensor) else np.transpose(a, (2, 1, 0))
    if layout == "dense":
        return a.t() if isinstance(a, torch.Tensor) else np.transpose(a)
    return a


def _get(tree, path: Sequence[str]):
    for key in path:
        tree = getattr(tree, key) if isinstance(tree, tuple) else tree[key]
    return tree


def jax_tree(named: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Port tensors by name -> {collection: tree} in the JAX package's
    layout, numpy float32 leaves, ``LSTMParams`` where it has them."""
    out: Dict[str, Any] = {}
    for name, t in named.items():
        collection, path, layout = jax_location(name)
        node = out.setdefault(collection, {})
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.ascontiguousarray(_relayout(t.detach().float().cpu().numpy(), layout))

    def wrap(node):
        if not isinstance(node, dict):
            return node
        if set(node) == set(LSTMParams._fields):
            return LSTMParams(**node)
        return {k: wrap(v) for k, v in node.items()}

    return {k: wrap(v) for k, v in out.items()}


def named_from_jax(trees: Mapping[str, Any], names: Sequence[str]) -> Dict[str, np.ndarray]:
    """The inverse of ``jax_tree``: {collection: tree} -> numpy arrays in
    the port's layout for each of ``names``."""
    out = {}
    for name in names:
        collection, path, layout = jax_location(name)
        out[name] = np.ascontiguousarray(_relayout(np.asarray(_get(trees[collection], path), np.float32), layout))
    return out


# ---------------------------------------------------------------------------
# Weight bridge: numpy trees in the JAX layout -> module state.
# ---------------------------------------------------------------------------


def _put(dst: torch.Tensor, src, transform=None) -> None:
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(src, np.float32)))
    if transform is not None:
        t = transform(t)
    if tuple(t.shape) != tuple(dst.shape):
        raise ValueError(f"shape mismatch: checkpoint {tuple(t.shape)}, module {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(t)


def _conv_weight(t):  # (W, I, O) -> (O, I, W)
    return t.permute(2, 1, 0)


def _put_conv(conv, entry) -> None:
    _put(conv.weight, entry["kernel"], _conv_weight)
    _put(conv.bias, entry["bias"])


def load_module(model, variables, prefix: str = "") -> None:
    """Copy a duration or acoustic variable tree into ``model``'s
    parameters and BatchNorm statistics (every tensor of its state dict);
    ``prefix`` names a submodule, as ``"encoder."`` for a ``TokenEncoder``
    and its {"params": {"encoder": ...}, ...} tree."""
    state = {prefix + k: v for k, v in model.state_dict(keep_vars=True).items()}
    for name, src in named_from_jax(variables, list(state)).items():
        _put(state[name], src)


def _put_encoder(enc, params, stats) -> None:
    load_module(enc, {"params": {"encoder": params}, "batch_stats": {"encoder": stats}}, "encoder.")


def load_duration(model, variables) -> None:
    load_module(model, variables)


def load_acoustic(model, variables) -> None:
    load_module(model, variables)
    model.merge_decoder_weights()


def load_generator(model, variables) -> None:
    """Copy generator params (plain or ``{v, g}``, folded here) into a
    plain ``Generator``; a weight-normalized one loads through
    ``named_from_gan_tree``."""
    if model.use_wn:
        raise ValueError("load_generator fills a plain Generator (use_wn=False)")
    p = fold_weight_norm(variables["params"])
    _put_conv(model.conv_pre, p["conv_pre"])
    _put_conv(model.conv_post, p["conv_post"])
    for i, ups in enumerate(model.ups):
        # (W, I, O) -> (I, O, W), mirrored on W (see ops.mrf.convt_weight_to_torch)
        _put(ups.weight, p[f"ups_{i}"]["kernel"], lambda t: t.flip(0).permute(1, 2, 0))
        _put(ups.bias, p[f"ups_{i}"]["bias"])
    for r, rb in enumerate(model.resblocks):
        block = p[f"resblock_{r}"]
        if rb.convs2 is not None:
            for j in range(len(rb.convs1)):
                _put_conv(rb.convs1[j], block[f"convs1_{j}"])
                _put_conv(rb.convs2[j], block[f"convs2_{j}"])
        else:
            for j in range(len(rb.convs1)):
                _put_conv(rb.convs1[j], block[f"convs_{j}"])
    model.clear_fused_weights()



# ---------------------------------------------------------------------------
# The GAN trainer's trees.
# ---------------------------------------------------------------------------


def gan_path(name: str, resblock2: bool = False) -> Tuple[str, ...]:
    """The path in the JAX package's GAN trees (``gen_params``,
    ``disc_params``, ``spectral``) of a port tensor: the weight-normalized
    generator's ``resblocks.3.convs1.2.v`` is ``resblock_3/convs1_2/v``
    (``convs_2`` in a ResBlock2) and ``ups.0.g`` is ``ups_0/g``; the
    discriminators' names (``mpd.disc_p2.conv_0.v``) and the spectral
    state's (``disc_s0.conv_0.u``) are their paths."""
    m = re.fullmatch(r"resblocks\.(\d+)\.convs([12])\.(\d+)\.(\w+)", name)
    if m:
        r, c, j, leaf = m.groups()
        return (f"resblock_{r}", f"convs_{j}" if resblock2 else f"convs{c}_{j}", leaf)
    return tuple(re.sub(r"^ups\.(\d+)\.", r"ups_\1.", name).split("."))


def _gan_layout(path: Sequence[str], ndim: int):
    if path[-1] not in ("v", "kernel"):
        return None
    if path[0].startswith("ups_"):
        return "convt"
    return "conv2d" if ndim == 4 else "conv"


def _gan_to_jax(a: np.ndarray, layout) -> np.ndarray:
    if layout == "convt":  # (I, O, W) -> (W, I, O), mirrored on W
        return np.flip(np.transpose(a, (2, 0, 1)), 0)
    if layout == "conv2d":  # (O, I, kh, kw) -> (kh, kw, I, O)
        return np.transpose(a, (2, 3, 1, 0))
    return np.transpose(a, (2, 1, 0)) if layout == "conv" else a


def _gan_from_jax(a: np.ndarray, layout) -> np.ndarray:
    if layout == "convt":
        return np.transpose(np.flip(a, 0), (1, 2, 0))
    if layout == "conv2d":
        return np.transpose(a, (3, 2, 0, 1))
    return np.transpose(a, (2, 1, 0)) if layout == "conv" else a


def gan_tree(named: Mapping[str, torch.Tensor], resblock2: bool = False) -> Dict[str, Any]:
    """Port tensors by name -> the JAX package's nested tree, numpy
    float32 leaves in its layout."""
    out: Dict[str, Any] = {}
    for name, t in named.items():
        path = gan_path(name, resblock2)
        a = t.detach().float().cpu().numpy()
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.ascontiguousarray(_gan_to_jax(a, _gan_layout(path, a.ndim)))
    return out


def named_from_gan_tree(tree, names: Sequence[str], resblock2: bool = False) -> Dict[str, np.ndarray]:
    """The inverse of ``gan_tree`` for each of ``names``."""
    out = {}
    for name in names:
        path = gan_path(name, resblock2)
        a = np.asarray(_get(tree, path), np.float32)
        out[name] = np.array(_gan_from_jax(a, _gan_layout(path, a.ndim)), order="C")  # a writable copy
    return out
