"""Carry a parameter tree of the JAX reference over to the port.

``params_from_reference(cfg, tree)`` takes the reference's
``build_model(cfg).init(key)[0]`` tree with its leaves as numpy arrays (or
anything ``numpy.asarray`` takes) and returns the port's parameters.  For
an ``LM``: ``embed`` / ``unembed``, ``final_norm``, ``units`` (a tuple over
unit positions of dicts stacked over ``repeats``; a MoE layer's ``moe``
holds ``router``, ``w_gate``, ``w_up``, ``w_down`` and ``norm``), ``tail``
and ``shared_attn``.  For an ``EncDec``: ``embed``, ``pos_dec``,
``pos_enc``, ``enc`` and ``dec`` stacked over layers, ``enc_norm`` and
``final_norm``.  The two packages store every leaf in the same layout
(attention weights 3-D, ``[d, H, hd]`` / ``[H, hd, d]``; experts
``[E, d, f]`` / ``[E, f, d]``), so the conversion is a copy; it checks
every key and shape against the model's ``param_shapes`` and raises on the
first difference, so both packages provably compute one function of the
same weights.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from .config import ModelConfig
from .registry import build_model


def _convert(want, got, path: str, dtype, device):
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            have = sorted(got) if isinstance(got, dict) else type(got)
            raise ValueError(f"params_from_reference: {path or 'root'} has "
                             f"keys {have}, expected {sorted(want)}")
        return {k: _convert(want[k], got[k], f"{path}/{k}", dtype, device)
                for k in want}
    if isinstance(want, tuple):
        if not isinstance(got, (tuple, list)) or len(got) != len(want):
            raise ValueError(f"params_from_reference: {path} should be a "
                             f"tuple of {len(want)} entries")
        return tuple(_convert(w, g, f"{path}[{i}]", dtype, device)
                     for i, (w, g) in enumerate(zip(want, got)))
    arr = np.asarray(got)
    if tuple(arr.shape) != tuple(want.shape):
        raise ValueError(f"params_from_reference: {path} has shape "
                         f"{arr.shape}, expected {tuple(want.shape)}")
    t = torch.from_numpy(np.array(arr, dtype=np.float32, copy=True))
    return t.to(device=device, dtype=dtype)


def params_from_reference(cfg: ModelConfig, tree: Any,
                          dtype: Optional[torch.dtype] = torch.float32,
                          device: DeviceLike = None):
    """The port's parameters holding the reference tree's values, in
    ``dtype`` on ``device`` (``None`` means ``"cuda"``)."""
    dev = resolve_device(device)
    want = build_model(cfg).param_shapes(dtype)
    return _convert(want, tree, "", dtype, dev)
