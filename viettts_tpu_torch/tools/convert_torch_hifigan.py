"""Convert upstream PyTorch HiFi-GAN checkpoints to native pickles
(counterpart of ``viettts_tpu/tools/convert_torch_hifigan.py``, with the
same output trees, which both packages read).

    python -m viettts_tpu_torch.tools.convert_torch_hifigan --checkpoint-file g_XXXX \\
        [--output-file OUT.pickle] [--do-file do_XXXX [--disc-output-file DISC.pickle]]

The generator (``g_*``) becomes inference params in the JAX package's
layout (``load_variables(..., "hifigan")``): weight norm folded, Conv1d
weights (O, I, W) -> (W, I, O), ConvTranspose1d (I, O, W) -> (W, I, O)
mirrored on W (torch applies the taps mirrored relative to
``lax.conv_transpose``).  The discriminators (``do_*``) become a
``--disc-init`` pickle for ``train.hifigan``: the MPD's weight-normalized
Conv2d keep ``{v, g}`` with ``weight_v`` (O, I, kh, kw) -> (kh, kw, I, O);
the MSD's first scale is spectrally normalized, ``weight_orig`` becomes
its kernel and ``weight_u`` its spectral ``u`` (sigma does not change
under the column permutation of the layout change); the other scales
are weight-normalized Conv1d.  Optimizer moments are not converted.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict

import numpy as np

from viettts_tpu_torch.checkpoint import NATIVE_FORMAT
from viettts_tpu_torch.train.checkpoint import save_checkpoint


def _np(val) -> np.ndarray:
    return val.detach().cpu().numpy() if hasattr(val, "detach") else np.asarray(val)


def _fuse_weight_norm(sd: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Fuse torch ``weight_norm`` pairs (``weight_g``, ``weight_v``) into
    plain weights; torch norms over every axis but dim 0."""
    out: Dict[str, np.ndarray] = {}
    for key, val in sd.items():
        arr = _np(val)
        if key.endswith("weight_v"):
            base = key[: -len("_v")]
            g = _np(sd[base + "_g"])
            norm = np.linalg.norm(arr.reshape(arr.shape[0], -1), axis=1).reshape((-1,) + (1,) * (arr.ndim - 1))
            out[base] = arr * (g / np.maximum(norm, 1e-12))
        elif not key.endswith("weight_g"):
            out[key] = arr
    return out


def convert_state_dict(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Torch generator state dict -> ``{"params": ...}`` of a plain
    generator."""
    params: Dict[str, Any] = {}
    for key, arr in _fuse_weight_norm(sd).items():
        if key.startswith(("conv_pre", "conv_post")):
            path, name = (key.split(".")[0],), key.split(".")[-1]
        elif key.startswith("ups."):
            _, idx, name = key.split(".")
            path = (f"ups_{idx}",)
        elif key.startswith("resblocks."):
            _, x, conv, z, name = key.split(".")
            path = (f"resblock_{x}", f"{conv}_{z}")
        else:
            raise ValueError(f"unexpected torch key {key}")
        node = params
        for part in path:
            node = node.setdefault(part, {})
        if name == "bias":
            node["bias"] = arr
        elif name == "weight":
            if path[0].startswith("ups_"):  # ConvTranspose1d (I, O, W), mirrored taps
                node["kernel"] = np.flip(np.transpose(arr, (2, 0, 1)), 0).copy()
            else:  # Conv1d (O, I, W)
                node["kernel"] = np.transpose(arr, (2, 1, 0))
        else:
            raise ValueError(f"unexpected leaf {name} in {key}")
    return {"params": params}


def _convert_disc_conv(sd: Dict[str, Any], prefix: str, is_2d: bool):
    """One discriminator conv (torch key prefix) -> (params, spectral u or
    None): ``{v, g, bias}`` under weight norm, ``{kernel, bias}`` and u
    under spectral norm, ``{kernel, bias}`` for a plain conv."""
    transpose = (2, 3, 1, 0) if is_2d else (2, 1, 0)
    out: Dict[str, np.ndarray] = {"bias": _np(sd[f"{prefix}.bias"])}
    u = None
    if f"{prefix}.weight_g" in sd:
        out["v"] = np.transpose(_np(sd[f"{prefix}.weight_v"]), transpose)
        out["g"] = _np(sd[f"{prefix}.weight_g"]).reshape(-1)
    elif f"{prefix}.weight_orig" in sd:
        out["kernel"] = np.transpose(_np(sd[f"{prefix}.weight_orig"]), transpose)
        u = _np(sd[f"{prefix}.weight_u"])
    else:
        out["kernel"] = np.transpose(_np(sd[f"{prefix}.weight"]), transpose)
    return out, u


def convert_discriminators(mpd_sd: Dict[str, Any], msd_sd: Dict[str, Any], periods=(2, 3, 5, 7, 11),
                           num_scales: int = 3):
    """Torch MPD/MSD state dicts -> (disc_params, spectral), the GAN
    trainer's trees: ``conv_0..conv_4`` + ``conv_post`` per period,
    ``conv_0..conv_6`` + ``conv_post`` per scale."""
    mpd: Dict[str, Any] = {}
    for i, p in enumerate(periods):
        layers = {f"conv_{j}": _convert_disc_conv(mpd_sd, f"discriminators.{i}.convs.{j}", True)[0]
                  for j in range(5)}
        layers["conv_post"] = _convert_disc_conv(mpd_sd, f"discriminators.{i}.conv_post", True)[0]
        mpd[f"disc_p{p}"] = layers
    msd: Dict[str, Any] = {}
    spectral: Dict[str, Any] = {}
    for i in range(num_scales):
        layers, us = {}, {}
        prefixes = [(f"conv_{j}", f"discriminators.{i}.convs.{j}") for j in range(7)]
        for name, prefix in prefixes + [("conv_post", f"discriminators.{i}.conv_post")]:
            layers[name], u = _convert_disc_conv(msd_sd, prefix, False)
            if u is not None:
                us[name] = {"u": u}
        msd[f"disc_s{i}"] = layers
        if us:
            spectral[f"disc_s{i}"] = us
    return {"mpd": mpd, "msd": msd}, spectral


def _torch_load(path: Path):
    import torch

    return torch.load(path, map_location="cpu", weights_only=True)


def convert_do_file(do_file: Path, output_file: Path) -> None:
    """An upstream ``do_*`` checkpoint -> a ``--disc-init`` pickle."""
    ckpt = _torch_load(do_file)
    disc_params, spectral = convert_discriminators(ckpt["mpd"], ckpt["msd"])
    save_checkpoint(output_file, {"format": NATIVE_FORMAT, "step": int(ckpt.get("steps", 0)),
                                  "disc_params": disc_params, "spectral": spectral})


def convert_file(checkpoint_file: Path, output_file: Path) -> None:
    """An upstream ``g_*`` checkpoint -> an inference pickle."""
    ckpt = _torch_load(checkpoint_file)
    variables = convert_state_dict(ckpt.get("generator", ckpt))
    save_checkpoint(output_file, {"format": NATIVE_FORMAT, "step": 0, "variables": variables})


def main(argv=None):
    from argparse import ArgumentParser

    parser = ArgumentParser(description="Convert torch HiFi-GAN to native")
    parser.add_argument("--checkpoint-file", type=Path, required=True)
    parser.add_argument("--output-file", type=Path, default=Path("assets/infore/hifigan/hifigan_latest_ckpt.pickle"))
    parser.add_argument("--do-file", type=Path, default=None,
                        help="upstream do_* checkpoint (MPD+MSD), converted for train.hifigan --disc-init")
    parser.add_argument("--disc-output-file", type=Path, default=None,
                        help="output for --do-file (default: hifigan_disc_ckpt.pickle next to --output-file)")
    args = parser.parse_args(argv)
    args.output_file.parent.mkdir(parents=True, exist_ok=True)
    convert_file(args.checkpoint_file, args.output_file)
    print("wrote", args.output_file)
    if args.do_file is not None:
        disc_out = args.disc_output_file or args.output_file.parent / "hifigan_disc_ckpt.pickle"
        convert_do_file(args.do_file, disc_out)
        print("wrote", disc_out)


if __name__ == "__main__":
    main()
