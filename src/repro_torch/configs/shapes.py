"""Assigned input-shape sets and per-arch applicability (skips).

Every LM-family arch runs 4 cells:
  train_4k     seq 4096,   global_batch 256   -> train_step
  prefill_32k  seq 32768,  global_batch 32    -> prefill
  decode_32k   cache 32768, global_batch 128  -> decode_step
  long_500k    cache 524288, global_batch 1   -> decode_step (sub-quadratic
               archs only; pure full-attention archs skip, see DESIGN.md)
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES = {
    "train_4k": Shape("train_4k", 4_096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32_768, 128, "decode"),
    "long_500k": Shape("long_500k", 524_288, 1, "decode"),
}

# long_500k needs sub-quadratic attention state: run only where the KV/
# recurrent state stays bounded (SWA / local:global / SSM / hybrid).
LONG_OK = {"gemma3-12b", "mixtral-8x7b", "rwkv6-7b", "zamba2-7b"}


def cells(arch: str):
    out = []
    for s in SHAPES.values():
        if s.name == "long_500k" and arch not in LONG_OK:
            continue
        out.append(s)
    return out


def skip_reason(arch: str, shape: str) -> Optional[str]:
    if shape == "long_500k" and arch not in LONG_OK:
        return ("pure full-attention architecture: 524k-token KV cache is "
                "quadratic-state; skipped per assignment note")
    return None
