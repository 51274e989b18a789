"""Unified model configuration covering all assigned architectures."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: Optional[int] = None          # default d_model // n_heads
    d_ff: int = 1024
    vocab: int = 1024
    act: str = "silu"                       # silu (SwiGLU) | gelu
    norm: str = "rms"                       # rms | layer (whisper)
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    # sliding window / local:global pattern (gemma3, mixtral)
    window: Optional[int] = None            # SWA size for "local"/"swa" layers
    local_ratio: int = 0                    # gemma3: N local layers per global
    # MoE
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_strategy: str = "ep"                # ep (experts sharded) | tp
    # "spmd" = global-sort dispatch (baseline); "shardmap" = explicit EP
    # with local dispatch + one psum per layer (see blocks.py; §Perf)
    moe_impl: str = "spmd"
    # SSM (mamba2 / zamba hybrid)
    ssm_state: int = 0
    ssm_heads: int = 0                      # mamba2 value heads
    ssm_head_dim: int = 64                  # mamba2 head dim (inner = H*P)
    ssm_groups: int = 1                     # B/C groups
    conv_kernel: int = 4
    shared_attn_every: int = 0              # zamba: shared attn block period
    # RWKV6
    rwkv_head_dim: int = 64
    # enc-dec (whisper)
    n_enc_layers: int = 0
    enc_seq: int = 1500                     # whisper 30 s @ 50 Hz frame stub
    # VLM (qwen2-vl): M-RoPE head-dim frequency sections (t, h, w)
    mrope_sections: Optional[Tuple[int, int, int]] = None

    # training
    max_seq: int = 4096

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def n_params(self) -> int:
        """Approximate parameter count (for roofline MODEL_FLOPS)."""
        d, v = self.d_model, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":     # rwkv6
            per = 2 * d * d + 3 * d * self.d_ff + 6 * d * 32 * 2
            return emb + self.n_layers * per
        att = d * (self.n_heads * self.hd) + \
            2 * d * (self.n_kv_heads * self.hd) + (self.n_heads * self.hd) * d
        if self.family == "hybrid":  # zamba2: mamba2 layers + one shared attn
            h, p, n = self.ssm_heads, self.ssm_head_dim, self.ssm_state
            inner = h * p
            per = d * (2 * inner + 2 * self.ssm_groups * n + h) + inner * d
            return emb + self.n_layers * per + att + 2 * d * self.d_ff * 3
        mlp = 3 * d * self.d_ff if self.act == "silu" else 2 * d * self.d_ff
        if self.n_experts:
            moe = self.n_experts * 3 * d * self.expert_d_ff + d * self.n_experts
            per = att + moe
        else:
            per = att + mlp
        layers = self.n_layers * per
        if self.family == "encdec":
            layers += self.n_enc_layers * (att + mlp) + self.n_layers * att
        return emb + layers

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        if not self.n_experts:
            return self.n_params()
        d = self.d_model
        full = self.n_params()
        moe_all = self.n_layers * self.n_experts * 3 * d * self.expert_d_ff
        moe_act = self.n_layers * self.top_k * 3 * d * self.expert_d_ff
        return full - moe_all + moe_act
