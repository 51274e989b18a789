"""DTensor's collectives staged through host memory.

Ranks that share one card cannot form an NCCL group (NCCL refuses two
ranks on one device), so they run gloo.  gloo carries CUDA tensors through
its ``c10d`` operations, but DTensor issues the functional collectives
(``torch.ops._c10d_functional``), and on an H100 with torch 2.11 those
kill the process when they meet CUDA tensors over gloo (a segmentation
fault where the result is wrapped).  Under :class:`HostStaged` each
functional collective whose inputs live on the card runs on host copies
of them, over the same group, and its result is copied back to the card.
The step and its kernels stay on the card; only the bytes a collective
moves cross to the host and back.  Tensors on other devices pass through
untouched, so the mode changes nothing where no staging is needed.
"""

from __future__ import annotations

import collections
import time
from typing import Dict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

from repro_torch.launch.collectives import collective_kind


class HostStaged(TorchDispatchMode):
    """``with HostStaged() as staged:`` runs every functional collective of
    ``launch/collectives.py``'s table on ``device_type`` tensors through
    host copies.  ``staged.ops``,
    ``staged.bytes`` and ``staged.seconds`` count them by op: calls, the
    bytes of their device inputs, and host seconds from the first copy
    down to the last copy up."""

    def __init__(self, device_type: str = "cuda"):
        super().__init__()
        self.device_type = device_type
        self.ops: Dict[str, int] = collections.Counter()
        self.bytes: Dict[str, int] = collections.Counter()
        self.seconds: Dict[str, float] = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        # DTensor first turns its op into local ops and collectives
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        name = func._schema.name
        on_device = [t for t in tree_flatten((args, kwargs))[0]
                     if isinstance(t, torch.Tensor)
                     and t.device.type == self.device_type]
        # c10d's own collectives carry CUDA tensors over gloo
        if (collective_kind(name) is None or name.startswith("c10d::")
                or not on_device):
            return func(*args, **kwargs)
        device = on_device[0].device
        t0 = time.perf_counter()
        host = tree_map(lambda t: t.cpu() if isinstance(t, torch.Tensor)
                        else t, (args, kwargs))
        out = func(*host[0], **host[1])
        # complete the host collective here (its work is registered on the
        # host tensor), then hand the caller a finished tensor on the card
        out = tree_map(lambda t: torch.ops._c10d_functional.wait_tensor(t)
                       .to(device) if isinstance(t, torch.Tensor) else t, out)
        self.ops[name] += 1
        self.bytes[name] += sum(t.numel() * t.element_size()
                                for t in on_device)
        self.seconds[name] += time.perf_counter() - t0
        return out
