#!/usr/bin/env python3
"""Some phases of ``chip_smoke.py`` alone, from one tree of the port.

Imports ``chip_smoke.py`` and ``src/`` of the tree given by ``--tree``
(default: this script's own tree), builds the kernels (``[build]``) and
runs the named phases in order, each as the whole script runs it, and
prints what each returned and its seconds.  The phases that take only the
card (``train_mesh``, ``decode_mesh``, ``float32_times``) are the ones it
can run::

    python3 scripts/chip_phases.py decode_mesh
    python3 scripts/chip_phases.py --tree build/parent train_mesh
    python3 scripts/chip_phases.py --src build/parent/src float32_times

To compare two trees on one card, unpack the other one under ``build/``
(``git archive``) and call this script for each in turns (base, this,
this, base) within one machine's session: ``--tree`` runs the other
tree's phases on its own package, ``--src`` this tree's phases (the same
shapes and gates) on the other tree's package and kernels.  Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--tree", type=pathlib.Path,
                default=pathlib.Path(__file__).resolve().parents[1],
                help="root of the tree whose chip_smoke.py and src/ run")
ap.add_argument("--src", type=pathlib.Path, default=None,
                help="the package tree (src/) whose kernels run; default "
                     "the --tree's own")
ap.add_argument("phases", nargs="+",
                choices=("train_mesh", "decode_mesh", "float32_times"))
# parsed where the module loads: spawned ranks import it again, with the
# same arguments, and must find the same tree first on their path
ARGS = ap.parse_args()
TREE = ARGS.tree.resolve()
SRC = (ARGS.src or TREE / "src").resolve()
sys.path[:0] = [str(TREE), str(SRC)]

import chip_smoke  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_phases.py: no CUDA card", file=sys.stderr)
        return 1
    mods = chip_smoke.load_modules()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(TREE, SRC, sys.version.split()[0], torch.__version__,
          torch.version.cuda, chip_smoke.nvidia_smi_line(), flush=True)
    chip_smoke.phase_build(mods.build)
    for phase in ARGS.phases:
        t0 = time.perf_counter()
        out = getattr(chip_smoke, f"phase_{phase}")(torch, mods, dev)
        print(phase, out, f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
