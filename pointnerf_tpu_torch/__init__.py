"""pointnerf_tpu_torch — the PyTorch + CUDA port of `pointnerf_tpu`.

The JAX package stays the reference; this package mirrors its module layout
and function names, and every Pallas kernel on a ported path becomes a CUDA
C++ kernel for Hopper under `csrc/`, built with nvcc at first use
(`ops/_build.py`). Each kernel sits beside a plain PyTorch version of the same
function, which runs only for tensors on the CPU.

Entry points that create tensors (`make_point_cloud`,
`init_aggregator_params`, `convert.*`, `renderer.ray_batch_from_numpy`) run
on `cuda` unless the caller passes `device="cpu"`; without a card they raise.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` means the card. A CUDA device on a host without one raises:
    the port never drops to the CPU unless asked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pointnerf_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch versions")
    return dev


class SliceNotPorted(NotImplementedError):
    """A configuration outside what the port implements so far."""


def not_ported(what: str, slice_name: str) -> SliceNotPorted:
    return SliceNotPorted(f"{what} is not ported yet (ROADMAP.md: {slice_name})")


__all__ = ["resolve_device", "SliceNotPorted", "not_ported"]
