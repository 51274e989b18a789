"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``"cuda"``.  A CUDA device without a card raises:
    the port never drops to the CPU unless the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}: cuda or cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested (device=None means 'cuda') but "
            f"torch.cuda.is_available() is False; pass device='cpu' to run "
            f"the plain PyTorch versions on the host")
    return dev


def int32_planes(planes, n_fields: int, device: DeviceLike = None
                 ) -> torch.Tensor:
    """An ``(n_fields, ...)`` int32 tensor on ``device`` from numpy planes
    (a stacked array, or a sequence of equal-shape arrays such as a JAX
    NamedTuple of planes after ``np.asarray``), always a fresh copy."""
    arr = np.array(planes, dtype=np.int32, copy=True)
    if arr.ndim < 1 or arr.shape[0] != n_fields:
        raise ValueError(f"expected {n_fields} planes, got an array of "
                         f"shape {arr.shape}")
    return torch.from_numpy(arr).to(resolve_device(device))
