"""DTensor's collectives among ranks of one host, through buffers that
every rank of a group maps.

:class:`~repro_torch.parallel.host_staged.HostStaged` carries each
collective of ranks that share one card through host copies and gloo's
TCP: about 0.3-0.45 GB/s a rank on an H100's host, most of a sharded
train step's time (``PERF.md`` section 5).  Under :class:`PeerStaged`,
each rank of a group writes its input into a buffer of its own that its
peers have mapped, the group meets in one tiny gloo collective, and each
rank builds its result from the buffers itself.  For CUDA tensors the
buffers live on the card and are shared by CUDA IPC
(``csrc/peer_buffers.cu``), so the bytes move card to card; for CPU
tensors they are files mapped shared (for the CPU tests).  Each rank
keeps two buffers a group, used in turn, so that one meeting a
collective keeps a rank from writing a buffer its peers still read
(:class:`_Group`).  Leaving the mode unmaps the peers' buffers and frees
the rank's own once the group has met.

The all-gather, reduce-scatter and all-reduce of ``_c10d_functional``
with a sum or a mean run this way; a reduction adds the ranks' blocks in
rank order, so every rank of an all-reduce holds the same bits.
Any other collective of ``launch/collectives.py``'s table is host-staged
as before.
"""

from __future__ import annotations

import ctypes
import os
import tempfile
import time
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.parallel.host_staged import HostStaged

_META = 256                 # a buffer's handle (or path)
_REDUCE_OPS = ("sum", "avg")


class _CardBuffers:
    """Buffers on the card, shared by CUDA IPC handles."""

    def __init__(self, device: torch.device):
        from repro_torch.kernels import _build

        self.lib = _build.build().lib
        self.device = device

    def _wrap(self, ptr: int, nbytes: int) -> torch.Tensor:
        holder = type("DeviceBytes", (), {"__cuda_array_interface__": {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "version": 2}})()
        return torch.as_tensor(holder, device=self.device)

    def _check(self, err: int, what: str) -> None:
        if err != 0:
            raise RuntimeError(f"peer buffer {what}: CUDA error {err}")

    def alloc(self, nbytes: int):
        ptr, handle = ctypes.c_void_p(), (ctypes.c_uint8 * 64)()
        self._check(self.lib.peer_buffer_alloc(
            nbytes, ctypes.addressof(ptr), ctypes.addressof(handle)),
            "alloc")
        return self._wrap(ptr.value, nbytes), bytes(handle), ptr.value

    def open(self, handle: bytes, nbytes: int):
        ptr, h = ctypes.c_void_p(), (ctypes.c_uint8 * 64)(*handle[:64])
        self._check(self.lib.peer_buffer_open(ctypes.addressof(h),
                                              ctypes.addressof(ptr)), "open")
        return self._wrap(ptr.value, nbytes), ptr.value

    def close(self, key) -> None:
        self._check(self.lib.peer_buffer_close(key), "close")

    def free(self, key) -> None:
        self._check(self.lib.peer_buffer_free(key), "free")

    def sync(self) -> None:
        torch.cuda.current_stream(self.device).synchronize()


class _FileBuffers:
    """Buffers in host memory: files mapped shared, named by their path."""

    def alloc(self, nbytes: int):
        fd, path = tempfile.mkstemp(prefix="peer_staged_")
        os.close(fd)
        t = torch.from_file(path, shared=True, size=nbytes,
                            dtype=torch.uint8)
        return t, path.encode(), path

    def open(self, handle: bytes, nbytes: int):
        path = handle.rstrip(b"\0").decode()
        return torch.from_file(path, shared=True, size=nbytes,
                               dtype=torch.uint8), None

    def close(self, key) -> None:
        pass                    # the mapping goes with its tensor

    def free(self, key) -> None:
        os.unlink(key)

    def sync(self) -> None:
        pass


class _Group:
    """One process group's buffers on this rank: two of its own, used in
    turn, and its peers' two mapped.

    Every rank of a group runs the group's collectives in the same order
    on inputs of the same size, so all of them grow the same buffer at
    the same collective: only then do they exchange handles (a gloo
    all-gather); any other collective meets in one tiny all-reduce, which
    says that every rank has written its input.  A rank writes a buffer
    again two collectives later, after the group's next meeting, which a
    peer joins only once it has read the buffer (its stream synchronised
    at its next write).  A buffer outgrown is freed after the meeting
    that follows the one where its peers learned of the new one, and
    unmapped it."""

    def __init__(self, pg, buffers):
        self.pg, self.buffers = pg, buffers
        self.me = dist.get_rank(pg)
        self.n = dist.get_world_size(pg)
        self.own: List[Optional[torch.Tensor]] = [None, None]
        self.keys: list = [None, None]
        self.caps = [0, 0]
        self.peers: List[Dict[int, tuple]] = [{}, {}]
        self.calls = 0
        self.retired: list = []     # (key, bytes, the collective's index)

    @property
    def held(self) -> int:
        """Bytes of buffers this rank holds for the group now."""
        return sum(self.caps) + sum(b for _, b, _ in self.retired)

    def exchange(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """Each rank's ``flat`` (uint8; the same length on every rank) as
        views of the group's buffers, by rank in the group; they stay valid
        until the group's next collective."""
        n = flat.numel()
        if not n:               # on every rank: nothing to move, no meeting
            return [flat] * self.n
        i, call = self.calls % 2, self.calls
        self.calls += 1
        grown = n > self.caps[i]
        if grown:
            if self.own[i] is not None:
                self.retired.append((self.keys[i], self.caps[i], call))
            cap = -(-max(n, self.caps[i] + self.caps[i] // 2)
                    // (1 << 20)) << 20
            self.own[i], handle, self.keys[i] = self.buffers.alloc(cap)
            self.caps[i] = cap
        self.own[i][:n].copy_(flat)
        self.buffers.sync()
        if grown:
            meta = torch.zeros(_META, dtype=torch.uint8)
            meta[:len(handle)] = torch.tensor(list(handle),
                                              dtype=torch.uint8)
            metas = [torch.empty_like(meta) for _ in range(self.n)]
            dist.all_gather(metas, meta, group=self.pg)
            for r, m in enumerate(metas):
                if r != self.me:
                    if r in self.peers[i]:
                        self.buffers.close(self.peers[i][r][1])
                    self.peers[i][r] = self.buffers.open(bytes(m),
                                                         self.caps[i])
        else:
            dist.all_reduce(torch.zeros(1), group=self.pg)
        for key, _, at in [t for t in self.retired if t[2] < call]:
            self.buffers.free(key)
        self.retired = [t for t in self.retired if t[2] >= call]
        return [self.own[i][:n] if r == self.me
                else self.peers[i][r][0][:n] for r in range(self.n)]

    def release(self, meet: bool) -> None:
        """Unmap the peers' buffers and, once every rank has (``meet``;
        not when leaving on an error, where the peers may never come),
        free this rank's own."""
        self.buffers.sync()
        for peers in self.peers:
            for _, key in peers.values():
                self.buffers.close(key)
            peers.clear()
        if meet:
            dist.all_reduce(torch.zeros(1), group=self.pg)
        for key in [k for k in self.keys if k is not None] + \
                [k for k, _, _ in self.retired]:
            self.buffers.free(key)
        self.own, self.keys, self.caps, self.retired = \
            [None, None], [None, None], [0, 0], []


def _as(view: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return view.view(like.dtype).view(like.shape)


class PeerStaged(HostStaged):
    """``with PeerStaged() as staged:`` runs the functional all-gather,
    reduce-scatter and all-reduce on ``device_type`` tensors through peer
    buffers (module docstring), every other collective of the table as
    :class:`HostStaged` does; ``staged.ops``, ``.bytes`` and ``.seconds``
    count both, by op: calls, the bytes of their inputs, host seconds;
    ``.peak_buffer_bytes`` is the most its buffers held at once."""

    def __init__(self, device_type: str = "cuda"):
        super().__init__(device_type)
        self._groups: Dict[str, _Group] = {}
        # the most bytes of buffers this rank held at once (device memory
        # outside PyTorch's allocator, on the card)
        self.peak_buffer_bytes = 0

    def __exit__(self, exc_type, exc, tb):
        try:
            return super().__exit__(exc_type, exc, tb)
        finally:
            for group in self._groups.values():
                group.release(meet=exc_type is None)
            self._groups.clear()

    def _group(self, group_name, device) -> _Group:
        pg = group_name
        if not isinstance(pg, dist.ProcessGroup):
            pg = dist.distributed_c10d._resolve_process_group(group_name)
        key = pg.group_name
        if key not in self._groups:
            buffers = (_CardBuffers(device) if device.type == "cuda"
                       else _FileBuffers())
            self._groups[key] = _Group(pg, buffers)
        return self._groups[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        name = func._schema.name
        x = args[0] if args else None
        op = None if name == "_c10d_functional::all_gather_into_tensor" \
            else (args[1] if len(args) > 1 else None)
        if (name not in _PEER or kwargs or not isinstance(x, torch.Tensor)
                or x.device.type != self.device_type
                or (op is not None and op not in _REDUCE_OPS)):
            return super().__torch_dispatch__(func, types, args, kwargs)
        t0 = time.perf_counter()
        x = x.contiguous()
        group = self._group(args[-1], x.device)
        views = [_as(v, x) for v in group.exchange(x.reshape(-1)
                                                   .view(torch.uint8))]
        self.peak_buffer_bytes = max(self.peak_buffer_bytes, sum(
            g.held for g in self._groups.values()))
        out = _PEER[name](views, group, op)
        self.ops[name] += 1
        self.bytes[name] += x.numel() * x.element_size()
        self.seconds[name] += time.perf_counter() - t0
        return out


def _gathered(views, group, op):
    return torch.cat(views)


def _reduced(parts, op, n):
    out = parts[0].clone()
    for p in parts[1:]:
        out += p
    return out.div_(n) if op == "avg" else out


def _scattered(views, group, op):
    rows = views[0].shape[0] // group.n
    return _reduced([v[group.me * rows:(group.me + 1) * rows]
                     for v in views], op, group.n)


def _all_reduced(views, group, op):
    return _reduced(views, op, group.n)


_PEER = {"_c10d_functional::all_gather_into_tensor": _gathered,
         "_c10d_functional::reduce_scatter_tensor": _scattered,
         "_c10d_functional::all_reduce": _all_reduced}
