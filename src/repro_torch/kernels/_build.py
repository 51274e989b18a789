"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Every ``csrc/*.cu`` of the package is compiled, at first use, by its own
``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler
-fPIC -c`` process, all started together, and the objects are linked by
one ``nvcc -shared`` into ``build/repro_torch/lib<hash>.so`` at the root
of the checkout, keyed by a hash of the sources, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header never loads
a stale library.  The sources export plain C
entry points (no PyTorch headers), which keeps the build to seconds.  A
failed build raises with nvcc's stderr.  Nothing is built at import: the
CPU tests import every module of the port on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_F32 = ctypes.c_float
# C entry point -> argtypes (every pointer and the stream as c_void_p)
ENTRY_POINTS = {
    "paxos_apply_launch": [_P, _P, _P, _P, _P, _I64, _P],
    "paxos_propose_launch": [_P, _P, _P, _P, _P, _I64, _I64, _P],
    # tab, staged, params, out, M, S, L, stream
    "paxos_propose_staged_launch": [_P, _P, _P, _P, _I64, _I64, _I64, _P],
    # q, k, v, out, B, Hq, Hkv, Sq, Sk, D, causal, window, scale, dtype,
    # stream
    "flash_attention_launch": [_P, _P, _P, _P, _I64, _I64, _I64, _I64,
                               _I64, _I64, _I64, _I64, _F32, _I64, _P],
    # x, dt, A, B, C, y, batch, T, H, P, G, N, dtype, stream
    "mamba2_ssd_launch": [_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64,
                          _I64, _I64, _I64, _P],
    # r, k, v, w, u, y, batch, H, T, K, V, dtype, stream
    "rwkv6_wkv_launch": [_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64,
                         _I64, _I64, _P],
    # the ranks of one card's shared buffers (parallel/peer_staged.py):
    # nbytes, out pointer, out handle; handle, out pointer; pointer
    "peer_buffer_alloc": [_I64, _P, _P],
    "peer_buffer_open": [_P, _P],
    "peer_buffer_close": [_P],
    "peer_buffer_free": [_P],
}

# Element type codes the float kernels take (``enum DType`` in
# ``csrc/flash_attention.cu``, ``csrc/mamba2_ssd.cu`` and
# ``csrc/rwkv6_wkv.cu``), by torch dtype name.
DTYPE_CODES = {"float32": 0, "bfloat16": 1}


def dtype_code(dtype) -> Optional[int]:
    """The kernels' code for a torch dtype, None where they take none."""
    return DTYPE_CODES.get(str(dtype).removeprefix("torch."))


class KernelLibrary:
    """The loaded shared library plus how it was obtained."""

    def __init__(self, lib: ctypes.CDLL, path: Path, build_seconds: float,
                 build_log: str):
        self.lib = lib
        self.path = path
        self.build_seconds = build_seconds   # 0.0 when a cached .so loaded
        self.build_log = build_log           # nvcc/ptxas output of the build


_loaded: Optional[KernelLibrary] = None


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda``,
    else whatever ``nvcc`` is on the PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, "
                           "PATH); the CUDA kernels cannot be built")
    return found


def sources():
    return sorted(CSRC.glob("*.cu"))


def headers():
    """The headers the sources include (from their own directory)."""
    return sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{h.hexdigest()[:16]}.so"


def _start(cmd):
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)


def _finish(jobs) -> str:
    """Wait for every ``(cmd, process)`` of ``jobs``; their output, or
    raise with the first failure's."""
    done = [(cmd, proc, "".join(proc.communicate())) for cmd, proc in jobs]
    for cmd, proc, log in done:
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    return "".join(log for _, _, log in done)


def _compile_and_link(out: Path) -> str:
    """One ``nvcc -c`` per source, all started together, then one link
    into ``out``; returns the compilers' output."""
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    try:
        log = _finish([_start([nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)])
                       for src, obj in zip(sources(), objs)])
        tmp = out.with_name(f"{tag}.tmp.so")
        log += _finish([_start([nvcc(), "-shared", "-o", str(tmp),
                                *map(str, objs)])])
        os.replace(tmp, out)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return log


def build() -> KernelLibrary:
    """Build (if the sources changed) and load the kernel library once per
    process."""
    global _loaded
    if _loaded is not None:
        return _loaded
    out = library_path()
    seconds, log = 0.0, ""
    if not out.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        log = _compile_and_link(out)
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(out))
    for name, argtypes in ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _loaded = KernelLibrary(lib, out, seconds, log)
    return _loaded
