"""The yardstick's card side: the card's peaks and the roofline.

Frozen copy of ``viettts_tpu_torch/utils/flops.py``'s ``Peaks``,
``H100_SXM``, ``H100_PCIE`` and ``peaks_for_name``, so that a change to the
program cannot move what it is measured against.  The operation and byte
counts of each model are its model module's
(``perfbench/reference/models/``).
"""

from __future__ import annotations

from typing import NamedTuple


class Peaks(NamedTuple):
    name: str
    bf16: float
    tf32: float
    fp32: float  # outside the tensor cores
    int8: float
    fp64_tensor: float
    hbm_bytes_per_s: float
    sm_count: int


# NVIDIA H100 data sheets, dense
H100_SXM = Peaks("H100 SXM", 989e12, 495e12, 67e12, 1979e12, 67e12, 3.35e12, 132)
H100_PCIE = Peaks("H100 PCIe", 756e12, 378e12, 51e12, 1513e12, 51e12, 2.0e12, 114)


def peaks_for_name(name: str) -> Peaks:
    """The peaks of a card as ``torch.cuda.get_device_name`` names it; raises
    on a card whose peaks are not known."""
    n = name.lower()
    if "h100" in n and "pcie" in n:
        return H100_PCIE
    if "h100" in n and ("hbm3" in n or "sxm" in n):
        return H100_SXM
    raise ValueError(f"no peaks known for {name!r} (known: NVIDIA H100 SXM, NVIDIA H100 PCIe)")


def bound_seconds(flop: float, bytes_: float, flops_per_s: float, peaks: Peaks) -> float:
    """The roofline: the larger of the operations at their peak and the
    bytes at the HBM rate."""
    return max(flop / flops_per_s, bytes_ / peaks.hbm_bytes_per_s)

