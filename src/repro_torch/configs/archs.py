"""The 10 assigned architectures — exact configs from the assignment table.

Each entry also defines a ``smoke`` reduction (same family/topology, tiny
dims) used by per-arch CPU smoke tests; full configs are exercised only via
the dry-run (ShapeDtypeStruct, no allocation).
"""

from __future__ import annotations

from typing import Dict

from repro_torch.models.config import ModelConfig

ARCHS: Dict[str, ModelConfig] = {}
SMOKE: Dict[str, ModelConfig] = {}


def _reg(cfg: ModelConfig, smoke: ModelConfig):
    ARCHS[cfg.name] = cfg
    SMOKE[cfg.name] = smoke


# -- dense ---------------------------------------------------------------------

_reg(
    ModelConfig(
        name="qwen1.5-4b", family="dense", n_layers=40, d_model=2560,
        n_heads=20, n_kv_heads=20, d_ff=6912, vocab=151936, qkv_bias=True,
        rope_theta=5e6),
    ModelConfig(
        name="qwen1.5-4b", family="dense", n_layers=4, d_model=128,
        n_heads=4, n_kv_heads=4, d_ff=352, vocab=512, qkv_bias=True),
)

_reg(
    ModelConfig(
        name="phi3-mini-3.8b", family="dense", n_layers=32, d_model=3072,
        n_heads=32, n_kv_heads=32, d_ff=8192, vocab=32064),
    ModelConfig(
        name="phi3-mini-3.8b", family="dense", n_layers=4, d_model=128,
        n_heads=4, n_kv_heads=4, d_ff=320, vocab=512),
)

_reg(
    ModelConfig(
        name="qwen2.5-32b", family="dense", n_layers=64, d_model=5120,
        n_heads=40, n_kv_heads=8, d_ff=27648, vocab=152064, qkv_bias=True,
        rope_theta=1e6),
    ModelConfig(
        name="qwen2.5-32b", family="dense", n_layers=4, d_model=128,
        n_heads=8, n_kv_heads=2, d_ff=384, vocab=512, qkv_bias=True),
)

_reg(
    ModelConfig(
        name="gemma3-12b", family="dense", n_layers=48, d_model=3840,
        n_heads=16, n_kv_heads=8, head_dim=256, d_ff=15360, vocab=262144,
        act="geglu", local_ratio=5, window=1024, rope_theta=1e6),
    ModelConfig(
        name="gemma3-12b", family="dense", n_layers=12, d_model=128,
        n_heads=4, n_kv_heads=2, head_dim=32, d_ff=384, vocab=512,
        act="geglu", local_ratio=5, window=64),
)

# -- vlm -------------------------------------------------------------------------

_reg(
    ModelConfig(
        name="qwen2-vl-72b", family="vlm", n_layers=80, d_model=8192,
        n_heads=64, n_kv_heads=8, d_ff=29568, vocab=152064, qkv_bias=True,
        rope_theta=1e6, mrope_sections=(16, 24, 24)),
    ModelConfig(
        name="qwen2-vl-72b", family="vlm", n_layers=4, d_model=128,
        n_heads=4, n_kv_heads=2, d_ff=384, vocab=512, qkv_bias=True,
        mrope_sections=(4, 6, 6)),
)

# -- moe --------------------------------------------------------------------------

_reg(
    ModelConfig(
        name="kimi-k2-1t-a32b", family="moe", n_layers=61, d_model=7168,
        n_heads=64, n_kv_heads=8, head_dim=112, d_ff=2048, vocab=163840,
        n_experts=384, top_k=8, expert_d_ff=2048, moe_strategy="ep",
        moe_impl="shardmap", rope_theta=1e6),
    ModelConfig(
        name="kimi-k2-1t-a32b", family="moe", n_layers=3, d_model=128,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
        n_experts=16, top_k=4, expert_d_ff=128, moe_strategy="ep"),
)

_reg(
    ModelConfig(
        name="mixtral-8x7b", family="moe", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=8, d_ff=14336, vocab=32000,
        n_experts=8, top_k=2, expert_d_ff=14336, moe_strategy="tp",
        moe_impl="shardmap", window=4096),
    ModelConfig(
        name="mixtral-8x7b", family="moe", n_layers=3, d_model=128,
        n_heads=4, n_kv_heads=2, d_ff=256, vocab=512,
        n_experts=4, top_k=2, expert_d_ff=256, moe_strategy="tp",
        window=64),
)

# -- audio enc-dec -----------------------------------------------------------------

_reg(
    ModelConfig(
        name="whisper-large-v3", family="encdec", n_layers=32,
        n_enc_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
        d_ff=5120, vocab=51866, act="gelu", norm="layer", enc_seq=1500,
        tie_embeddings=True, max_seq=32768),
    ModelConfig(
        name="whisper-large-v3", family="encdec", n_layers=3,
        n_enc_layers=3, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
        vocab=512, act="gelu", norm="layer", enc_seq=64,
        tie_embeddings=True, max_seq=256),
)

# -- ssm ----------------------------------------------------------------------------

_reg(
    ModelConfig(
        name="rwkv6-7b", family="ssm", n_layers=32, d_model=4096,
        n_heads=0, n_kv_heads=0, d_ff=14336, vocab=65536,
        rwkv_head_dim=64),
    ModelConfig(
        name="rwkv6-7b", family="ssm", n_layers=3, d_model=128,
        n_heads=0, n_kv_heads=0, d_ff=256, vocab=512, rwkv_head_dim=32),
)

# -- hybrid ---------------------------------------------------------------------------

_reg(
    ModelConfig(
        name="zamba2-7b", family="hybrid", n_layers=81, d_model=3584,
        n_heads=32, n_kv_heads=32, head_dim=112, d_ff=14336, vocab=32000,
        ssm_state=64, ssm_heads=112, ssm_head_dim=64, ssm_groups=1,
        shared_attn_every=6),
    ModelConfig(
        name="zamba2-7b", family="hybrid", n_layers=8, d_model=128,
        n_heads=4, n_kv_heads=4, head_dim=32, d_ff=256, vocab=512,
        ssm_state=16, ssm_heads=4, ssm_head_dim=32, ssm_groups=1,
        shared_attn_every=3),
)


def get(name: str, smoke: bool = False) -> ModelConfig:
    table = SMOKE if smoke else ARCHS
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; have {sorted(table)}")
    return table[name]
