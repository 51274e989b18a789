"""Roofline terms of every (arch x shape) cell, at H100 constants.

Port of ``repro.launch.roofline``.  Per cell, the terms in seconds (the
card's datasheet figures in ``launch/mesh.py``, not measurements):

    compute    = FLOPs            / (chips * 989e12)
    memory     = HBM bytes        / (chips * 3.35e12)
    collective = collective bytes / 450e9

FLOPs and HBM bytes are the reference's analytic models, with its
arithmetic (``==`` in ``tests/test_torch_roofline.py``):

  train   : FLOPs = 6 * N_active * tokens  * (4/3 remat)  + attention term
            12 * L * d * t * s_eff (causal halved)
  prefill : 2 * N_active * tokens + attention term
  decode  : 2 * N_active * batch + 2 * KV_bytes/2 matmul FLOPs (s*d per head)
  HBM     : train: params+grads+moments r/w + activation traffic
            decode: params + full KV cache read per token (the classic
            decode roofline: bandwidth-bound)

The reference takes its collective bytes from the compiled HLO.  The
port's dry run counts them by running the cell's step on DTensors over a
fake process group (``dryrun.py --collectives``, ``launch/collectives.py``):
bytes a device, summed over the kinds, over NVLink 4's one-direction rate.
Those are DTensor's eager choices of collectives, not XLA's partitioner's,
so the table heads the term ``dt-coll``.  A record without them (``"collectives": None``) has ``t_collective`` None,
and its dominant term is taken over compute and memory only.
"""

from __future__ import annotations

import argparse
import glob
import json
from typing import Dict, Optional

from repro_torch.configs.archs import ARCHS
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import derive_unit
from repro_torch.models.registry import VISION_TOKENS


def _attn_flops(cfg: ModelConfig, tokens: int, seq: int, *,
                train: bool) -> float:
    """Global attention matmul FLOPs (QK^T + PV), causal halving, window
    capping, per layer kind."""
    if cfg.family == "ssm":
        # wkv state math: T * K * V * heads * ~6 flops
        nh = cfg.d_model // cfg.rwkv_head_dim
        per_tok = 6 * nh * cfg.rwkv_head_dim * cfg.rwkv_head_dim
        return cfg.n_layers * tokens * per_tok * (3 if train else 1)
    total = 0.0
    hd, hq = cfg.hd, cfg.n_heads
    unit = derive_unit(cfg) if cfg.family != "encdec" else ["attn"]
    layers = cfg.n_layers
    for li in range(layers):
        kind = unit[li % len(unit)]
        s_eff = seq / 2            # causal average
        if kind in ("swa", "moe_swa", "local") and cfg.window:
            s_eff = min(seq / 2, cfg.window)
        total += 4 * tokens * s_eff * hq * hd
    if cfg.family == "hybrid":
        # mamba layers have SSD instead: T * H * N * P * ~6
        total = 0.0
        inner = cfg.ssm_heads * cfg.ssm_head_dim
        total += cfg.n_layers * tokens * 6 * cfg.ssm_state * inner
        n_shared = cfg.n_layers // max(cfg.shared_attn_every, 1)
        total += n_shared * 4 * tokens * (seq / 2) * hq * hd
    if cfg.family == "encdec":
        enc_tok = cfg.enc_seq * (tokens // max(seq, 1))
        total += cfg.n_enc_layers * 4 * enc_tok * cfg.enc_seq * hq * hd
        total += cfg.n_layers * 4 * tokens * cfg.enc_seq * hq * hd  # cross
    return total * (3 if train else 1)


def analytic_flops(cfg: ModelConfig, shape) -> float:
    b, s = shape.global_batch, shape.seq_len
    n_act = cfg.n_active_params()
    if shape.kind == "train":
        tokens = b * s
        # fwd+bwd = 3x fwd; remat of the layer stack re-runs fwd: ~4x
        base = 8 * n_act * tokens
        return base + _attn_flops(cfg, tokens, s, train=True)
    if shape.kind == "prefill":
        tokens = b * s + (b * VISION_TOKENS if cfg.family == "vlm" else 0)
        return 2 * n_act * tokens + _attn_flops(cfg, tokens, s, train=False)
    # decode: one token per sequence; attention reads the whole cache
    tokens = b
    base = 2 * n_act * tokens
    if cfg.family == "ssm":
        nh = cfg.d_model // cfg.rwkv_head_dim
        base += cfg.n_layers * b * 6 * nh * cfg.rwkv_head_dim ** 2
        return base
    if cfg.family == "hybrid":
        inner = cfg.ssm_heads * cfg.ssm_head_dim
        base += cfg.n_layers * b * 6 * cfg.ssm_state * inner
        n_shared = cfg.n_layers // max(cfg.shared_attn_every, 1)
        base += n_shared * 4 * b * s * cfg.n_heads * cfg.hd
        return base
    unit = derive_unit(cfg)
    for li in range(cfg.n_layers):
        kind = unit[li % len(unit)]
        s_eff = s
        if kind in ("swa", "moe_swa", "local") and cfg.window:
            s_eff = min(s, cfg.window)
        base += 4 * b * s_eff * cfg.n_heads * cfg.hd
    if cfg.family == "encdec":
        base += cfg.n_layers * 4 * b * cfg.enc_seq * cfg.n_heads * cfg.hd
    return base


def kv_cache_bytes(cfg: ModelConfig, b: int, s: int) -> float:
    """Global decode-state bytes (bf16 KV, f32 recurrent states)."""
    if cfg.family == "ssm":
        nh = cfg.d_model // cfg.rwkv_head_dim
        return b * cfg.n_layers * (nh * cfg.rwkv_head_dim ** 2 * 4
                                   + 2 * cfg.d_model * 2)
    if cfg.family == "hybrid":
        inner = cfg.ssm_heads * cfg.ssm_head_dim
        st = b * cfg.n_layers * (cfg.ssm_state * inner * 4 + 3 * 2 * inner)
        n_shared = cfg.n_layers // max(cfg.shared_attn_every, 1)
        st += n_shared * b * 2 * cfg.n_kv_heads * s * cfg.hd * 2
        return st
    unit = derive_unit(cfg)
    total = 0.0
    for li in range(cfg.n_layers):
        kind = unit[li % len(unit)]
        s_eff = s
        if kind in ("swa", "moe_swa", "local") and cfg.window:
            s_eff = min(s, cfg.window)
        total += b * 2 * cfg.n_kv_heads * s_eff * cfg.hd * 2
    if cfg.family == "encdec":
        total += cfg.n_layers * b * 2 * cfg.n_kv_heads * cfg.enc_seq \
            * cfg.hd * 2
    return total


def analytic_hbm_bytes(cfg: ModelConfig, shape) -> float:
    """Global HBM traffic per step (both directions)."""
    n = cfg.n_params()
    b, s = shape.global_batch, shape.seq_len
    d = cfg.d_model
    if shape.kind == "train":
        tokens = b * s
        state_b = 4 if n <= 2e11 else 2
        # params read (fwd+bwd+remat-fwd ~3x) + grads w + moments r/w +
        # params w + activations (remat: ~2 r/w of L*d per token * 12-ish)
        traffic = n * 2 * 3 + n * 2 + n * state_b * 4 + n * 2
        traffic += tokens * cfg.n_layers * d * 2 * 8
        return traffic
    if shape.kind == "prefill":
        tokens = b * s
        return n * 2 + tokens * cfg.n_layers * d * 2 * 4
    # decode: read active params once + the whole KV/state once
    return cfg.n_active_params() * 2 + kv_cache_bytes(cfg, b, s)


def terms(rec: Dict, cfg: ModelConfig) -> Optional[Dict]:
    """The roofline terms of one dry-run record (``launch/dryrun.py``)."""
    if "skipped" in rec:
        return None
    shape = SHAPES[rec["shape"]]
    chips = rec["chips"]
    flops = analytic_flops(cfg, shape)
    hbm = analytic_hbm_bytes(cfg, shape)
    t_compute = flops / chips / PEAK_FLOPS_BF16
    t_memory = hbm / chips / HBM_BW
    cands = [(t_compute, "compute"), (t_memory, "memory")]
    coll = None
    t_coll = None
    if rec.get("collectives") is not None:
        # per-device result shapes under SPMD, as the reference parses them
        coll = sum(v for k, v in rec["collectives"].items()
                   if not k.startswith("count"))
        t_coll = coll / NVLINK_BW
        cands.append((t_coll, "collective"))
    dom = max(cands)
    model_flops = (6 if shape.kind == "train" else 2) \
        * cfg.n_active_params() * (shape.global_batch * shape.seq_len
                                   if shape.kind != "decode"
                                   else shape.global_batch)
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "t_compute": t_compute, "t_memory": t_memory,
        "t_collective": t_coll, "dominant": dom[1],
        "bound_s": dom[0],
        "roofline_frac": dom[0] and t_compute / dom[0],
        "model_flops": model_flops,
        "useful_ratio": model_flops / max(flops, 1.0),
        "mem_per_dev_gb": rec["bytes_per_device"]["total"] / 1e9,
        "coll_gb": None if coll is None else coll / 1e9,
    }


def _cell(x, width: int, fmt: str) -> str:
    return f"{'n/a':>{width}s}" if x is None else f"{x:{width}{fmt}}"


def fmt_table(rows) -> str:
    hdr = (f"{'arch':18s} {'shape':12s} {'mesh':8s} "
           f"{'compute(s)':>11s} {'memory(s)':>10s} {'dt-coll(s)':>10s} "
           f"{'dominant':>10s} {'frac':>6s} {'mem/dev':>8s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r['arch']:18s} {r['shape']:12s} {r['mesh']:8s} "
            f"{r['t_compute']:11.4f} {r['t_memory']:10.4f} "
            f"{_cell(r['t_collective'], 10, '.4f')} {r['dominant']:>10s} "
            f"{r['roofline_frac']:6.2f} {r['mem_per_dev_gb']:7.2f}G")
    lines.append("dt-coll: the collectives DTensor issues in the step "
                 "(launch/collectives.py), not XLA's; n/a where not counted")
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser(
        description="Roofline table of the port's dry-run records")
    ap.add_argument("--glob", default="artifacts/torch_dryrun_*.json")
    ap.add_argument("--out", default="artifacts/torch_roofline.json")
    args = ap.parse_args()
    rows = []
    for path in sorted(glob.glob(args.glob)):
        with open(path) as f:
            for rec in json.load(f):
                t = terms(rec, ARCHS[rec["arch"]])
                if t:
                    rows.append(t)
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    print(fmt_table(rows))
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
