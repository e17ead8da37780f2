"""Checkpoint reading and the weight bridge (counterpart of the load side of
``viettts_tpu/train/checkpoint.py`` and ``models/hifigan.py::fold_weight_norm``).

Everything here is numpy until the bridge copies a tree into a module:

* ``load_variables`` reads a native ``viettts_tpu/v1`` pickle or one of the
  three reference haiku pickles and returns the JAX package's variable
  tree ({"params": ..., "batch_stats": ...}) with numpy leaves.  Native
  pickles name the JAX package's ``LSTMParams`` class; ``_PortUnpickler``
  maps it to this module's numpy NamedTuple, so reading never imports jax.
* ``load_duration`` / ``load_acoustic`` / ``load_generator`` copy such a
  tree into the port's modules, converting layouts: conv kernels
  (W, I, O) -> (O, I, W); ConvTranspose (W, I, O) -> (I, O, W) mirrored on
  W; dense kernels [in, out] -> ``nn.Linear`` [out, in]; LSTMs keep the
  fused JAX layout.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Any, Dict, NamedTuple

import numpy as np
import torch

NATIVE_FORMAT = "viettts_tpu/v1"


class LSTMParams(NamedTuple):
    """numpy stand-in for ``viettts_tpu.ops.rnn.LSTMParams`` (same fields)."""

    w_i: np.ndarray  # [D, 4H]
    w_h: np.ndarray  # [H, 4H]
    b: np.ndarray  # [4H]


class _Opaque(tuple):
    """Inert stand-in for optimizer-state classes in training checkpoints
    (``optax`` NamedTuples): the port reads only ``variables``."""

    def __new__(cls, *args):
        return tuple.__new__(cls, args)


class _PortUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if (module, name) == ("viettts_tpu.ops.rnn", "LSTMParams"):
            return LSTMParams
        root = module.split(".")[0]
        if root == "optax":
            return _Opaque
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


def _put_bn(bn, params, stats) -> None:
    _put(bn.weight, params["scale"])
    _put(bn.bias, params["bias"])
    _put(bn.running_mean, stats["mean"])
    _put(bn.running_var, stats["var"])


def _put_lstm(lstm, p) -> None:
    _put(lstm.w_i, p.w_i)
    _put(lstm.w_h, p.w_h)
    _put(lstm.b, p.b)


def _put_encoder(enc, params, stats) -> None:
    _put(enc.embed.weight, params["embed"]["embedding"])
    for i in range(3):
        _put_conv(enc.convs[i], params[f"conv_{i}"])
        _put_bn(enc.bns[i], params[f"bn_{i}"], stats[f"bn_{i}"])
    _put_lstm(enc.lstm_fwd, params["lstm_fwd"])
    _put_lstm(enc.lstm_bwd, params["lstm_bwd"])


def _put_dense(linear, entry) -> None:
    _put(linear.weight, entry["kernel"], lambda t: t.t())
    _put(linear.bias, entry["bias"])


def load_duration(model, variables) -> None:
    p, s = variables["params"], variables["batch_stats"]
    _put_encoder(model.encoder, p["encoder"], s["encoder"])
    _put_dense(model.proj_0, p["proj_0"])
    _put_dense(model.proj_1, p["proj_1"])


def load_acoustic(model, variables) -> None:
    p, s = variables["params"], variables["batch_stats"]
    _put_encoder(model.encoder, p["encoder"], s["encoder"])
    _put_lstm(model.lstm1, p["decoder_lstm1"])
    _put_lstm(model.lstm2, p["decoder_lstm2"])
    _put(model.prenet_fc1, p["prenet_fc1"]["kernel"])
    _put(model.prenet_fc2, p["prenet_fc2"]["kernel"])
    _put(model.proj_kernel, p["projection"]["kernel"])
    _put(model.proj_bias, p["projection"]["bias"])
    for i in range(5):
        _put_conv(model.postnet_convs[i], p[f"postnet_conv_{i}"])
    for i in range(4):
        _put_bn(model.postnet_bns[i], p[f"postnet_bn_{i}"], s[f"postnet_bn_{i}"])
    model.merge_decoder_weights()


def load_generator(model, variables) -> None:
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

