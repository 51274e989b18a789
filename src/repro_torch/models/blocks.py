"""Layer blocks: attention (GQA / RoPE / M-RoPE / sliding window /
non-causal / cross), MLP, MoE, Mamba2 and RWKV6.

Port of ``repro.models.blocks``.  Every block is a pair of plain functions
on tensors::

    init_<block>(cfg, init, lead=())  -> params (a dict of tensors)
    apply_<block>(cfg, params, x, ...) -> y  (or (y, aux) / (y, new_cache))

``lead`` prefixes every parameter's shape (the LM stacks a unit position's
layers over ``repeats`` that way).  The full-sequence attention goes
through :func:`repro_torch.kernels.flash_attention.ops.flash_attention`,
the Mamba2 mixing through :func:`repro_torch.kernels.mamba2_ssd.ops.ssd`
and the RWKV6 time mixing through
:func:`repro_torch.kernels.rwkv6_wkv.ops.wkv6`: on a CUDA tensor they
launch the CUDA kernels.  Decode steps and the MoE dispatch stay plain
PyTorch, as the reference computes them outside Pallas.

Each block's ``<block>_specs(cfg)`` gives the reference's logical axes of
its parameters (``repro_torch.parallel.sharding``), which the reference's
``init_<block>`` returns beside the arrays; the port's ``init_<block>``
returns the tensors only.  Under a
:func:`~repro_torch.parallel.sharding.use_mesh` block whose mesh has a
"model" axis, :func:`apply_moe` of a ``moe_impl="shardmap"`` config runs
:func:`apply_moe_shardmap` over the mesh's process groups.

Parameters placed on a ``DeviceMesh`` as DTensors (``launch/steps.py``
``place_cell``) run the same code: the blocks constrain their
activations where the reference does, and where DTensor needs a layout
(:func:`~repro_torch.parallel.sharding.shard`, a redistribute; a no-op on
plain tensors), and the attention, WKV and SSD kernels run on each rank's
block of batch and heads (:func:`_on_blocks`), as do the RWKV6 and Mamba2
decode steps on their states' blocks.  The MoE keeps each path's
semantics there: the shard_map path on each rank's blocks laid out as
the reference's ``in_specs``, the spmd path routing the global batch.

Decode caches are updated in place where that saves a copy of the whole
cache: :func:`apply_attention_decode` writes the new key and value into the
cache tensors it is given and returns them with ``length + 1``;
:func:`apply_mamba2_decode` and :func:`apply_rwkv6_decode` return new
(small) tensors.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed import _functional_collectives as funcol
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.distributed.tensor.experimental import local_map
from torch.profiler import record_function

from repro_torch.kernels.flash_attention.ops import (
    decode_attention, flash_attention,
)
from repro_torch.kernels.mamba2_ssd.ops import ssd, ssd_decode
from repro_torch.kernels.rwkv6_wkv.ops import wkv6, wkv6_decode
from repro_torch.parallel.sharding import (
    current_mesh, mesh_axes, mesh_axis_sizes, placements, resolve, shard,
)
from .common import Init, apply_mrope, apply_rope, rms_norm
from .config import ModelConfig

CacheSpec = Tuple[Tuple[int, ...], torch.dtype]     # (shape, dtype)
Specs = Dict[str, tuple]                            # leaf -> logical axes


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with JAX's dtype promotion (torch.matmul wants one dtype)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def norm_apply(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layer":
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + 1e-5)
        return y.to(x.dtype) * p["scale"] + p["bias"]
    return rms_norm(x, p["scale"])


def init_norm(cfg: ModelConfig, init: Init, d: Optional[int] = None,
              lead: Sequence[int] = ()):
    d = d or cfg.d_model
    lead = tuple(lead)
    if cfg.norm == "layer":
        return {"scale": init.ones(lead + (d,)),
                "bias": init.zeros(lead + (d,))}
    return {"scale": init.ones(lead + (d,))}


def norm_specs(cfg: ModelConfig) -> Specs:
    if cfg.norm == "layer":
        return {"scale": (None,), "bias": (None,)}
    return {"scale": (None,)}


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def init_attention(cfg: ModelConfig, init: Init, lead: Sequence[int] = ()):
    """Projections stay 3-D, as the reference stores them: ``wq/wk/wv``
    ``[d, H, hd]``, ``wo`` ``[H, hd, d]``."""
    d, hd = cfg.d_model, cfg.hd
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    lead = tuple(lead)
    p = dict(
        wq=init.normal(lead + (d, hq, hd)),
        wk=init.normal(lead + (d, hkv, hd)),
        wv=init.normal(lead + (d, hkv, hd)),
        wo=init.normal(lead + (hq, hd, d)),
        norm=init_norm(cfg, init, lead=lead),
    )
    if cfg.qkv_bias:
        p.update(bq=init.zeros(lead + (hq, hd)),
                 bk=init.zeros(lead + (hkv, hd)),
                 bv=init.zeros(lead + (hkv, hd)))
    return p


def attention_specs(cfg: ModelConfig) -> Specs:
    """The head dim stays explicit, so the divisibility-aware resolver
    replicates heads a model axis does not divide (8 KV heads on 16)."""
    s = dict(wq=("embed_fsdp", "heads", None),
             wk=("embed_fsdp", "kv_heads", None),
             wv=("embed_fsdp", "kv_heads", None),
             wo=("heads", None, "embed_fsdp"),
             norm=norm_specs(cfg))
    if cfg.qkv_bias:
        s.update(bq=("heads", None), bk=("kv_heads", None),
                 bv=("kv_heads", None))
    return s


# On DTensors a weight is laid out for its product where it is used: its
# "embed_fsdp" dim gathered over "data" (FSDP; the gradient's way back is a
# reduce-scatter), its tensor-parallel dim kept.  Every product then has a
# layout that needs no further collective, and DTensor takes it rather
# than one of its own choosing.
#
# The head projections are the reference's einsums written as the one
# product einsum runs over the flattened heads x head dim (equal bits on the
# CPU).  Each flattened operand takes its heads' layout judged on the head
# count, and so does its gradient (``shard``'s backward): a count the model
# axis does not divide (20 heads on 16) replicates, where DTensor alone may
# cut the flat dim inside a head and then fail to split it.

def _heads(x: torch.Tensor, w: torch.Tensor, axis: str) -> torch.Tensor:
    """``einsum("bsd,dhk->bhsk", x, w)``; ``axis`` names the heads."""
    b, s, d = x.shape
    h, hd = w.shape[1], w.shape[2]
    wf = shard(w.reshape(d, h * hd).to(x.dtype), (None, axis), sizes=(d, h))
    y = shard(x @ wf, ("batch", None, axis), sizes=(b, s, h))
    return y.reshape(b, s, h, hd).transpose(1, 2)


def _heads_out(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bhsk,hkd->bsd", o, w)``."""
    b, h, s, hd = o.shape
    d = w.shape[-1]
    of = shard(o.transpose(1, 2).reshape(b, s, h * hd),
               ("batch", None, "heads"), sizes=(b, s, h))
    wf = shard(w.reshape(h * hd, d).to(o.dtype), ("heads", None),
               sizes=(h, d))
    return of @ wf


def _qkv(cfg: ModelConfig, p, x: torch.Tensor):
    q = _heads(x, p["wq"], "heads")
    k = _heads(x, p["wk"], "kv_heads")
    v = _heads(x, p["wv"], "kv_heads")
    if cfg.qkv_bias:
        q = q + p["bq"][None, :, None, :]
        k = k + p["bk"][None, :, None, :]
        v = v + p["bv"][None, :, None, :]
    q = shard(q, ("batch", "heads", None, None))
    k = shard(k, ("batch", "kv_heads", None, None))
    v = shard(v, ("batch", "kv_heads", None, None))
    return q, k, v


def _rope_qk(cfg: ModelConfig, q, k, positions, mrope_positions=None):
    """M-RoPE when the config has sections and the [3, B, S] streams are
    given; RoPE by ``positions`` [B, S] otherwise."""
    if cfg.mrope_sections is not None and mrope_positions is not None:
        return (apply_mrope(q, mrope_positions, cfg.mrope_sections,
                            cfg.rope_theta),
                apply_mrope(k, mrope_positions, cfg.mrope_sections,
                            cfg.rope_theta))
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta))


def apply_attention(cfg: ModelConfig, p, x: torch.Tensor, *, positions,
                    window: Optional[int] = None, causal: bool = True,
                    mrope_positions=None,
                    kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Full-sequence attention: prefill and training, the encoder
    (``causal=False``) and cross-attention (``kv``, the encoder's keys and
    values [B, Hkv, Sk, hd], which replace this block's own and are not
    rotated).  ``positions=None`` rotates nothing."""
    h = norm_apply(cfg, p["norm"], x)
    q, k, v = _qkv(cfg, p, h)
    if kv is not None:
        k, v = kv
    elif positions is not None:
        q, k = _rope_qk(cfg, q, k, positions, mrope_positions)
    o = _attention(q, k, v, causal=causal, window=window)
    return shard(x + _heads_out(o, p["wo"]), ("batch", None, None))


def _attention(q, k, v, *, causal: bool, window: Optional[int]):
    """:func:`flash_attention` on each rank's block of DTensor q, k, v
    (batch over "batch", heads over "heads" / "kv_heads", resolved
    against the shapes; where the model axis divides one head count and
    not the other, both replicate, so each block keeps whole GQA groups),
    its backward on the blocks too (:func:`_on_blocks`); on plain tensors
    as they are."""
    def kernel(q, k, v):
        return flash_attention(q, k, v, causal=causal, window=window)

    if not isinstance(q, DTensor):
        return kernel(q, k, v)
    mesh = q.device_mesh
    sq = resolve(("batch", "heads", None, None), mesh, tuple(q.shape))
    sk = resolve(("batch", "kv_heads", None, None), mesh, tuple(k.shape))
    if sq[1] != sk[1]:
        sq, sk = sq[:1] + (None,) + sq[2:], sk[:1] + (None,) + sk[2:]
    pq, pk = placements(sq, mesh), placements(sk, mesh)
    return _on_blocks(kernel, (q.redistribute(mesh, pq),
                               k.redistribute(mesh, pk),
                               v.redistribute(mesh, pk)))


def _on_blocks(kernel, args, outs=(0,)):
    """``kernel(*args)`` on each rank's block of DTensor ``args``, laid
    out as they come: ``local_map``, its backward on the blocks too.
    Output ``i`` takes the layout of ``args[outs[i]]``.  On plain tensors
    ``kernel(*args)`` as it is.

    The first arg's layout is the work's split.  An input replicated over
    a mesh dim that splits the work (the WKV's bonus, the SSD's decay
    rates over the batch; B and C shared by the heads over "model") gets
    from its block's backward only that block's share of its gradient,
    the sum over the other blocks left out: its gradient is declared
    ``Partial`` over that dim, which DTensor adds up where it is read.
    Declared as the input's own layout, each rank's share would pass for
    the whole sum."""
    if not isinstance(args[0], DTensor):
        return kernel(*args)
    pls = [a.placements for a in args]
    grads = tuple(tuple(Partial() if p.is_replicate() and w.is_shard()
                        else p for p, w in zip(pl, pls[0])) for pl in pls)
    # out_placements a list for one output: local_map reads a tuple as one
    # an output
    out = (list(pls[outs[0]]) if len(outs) == 1
           else tuple(list(pls[i]) for i in outs))
    return local_map(kernel, out_placements=out, in_placements=tuple(pls),
                     in_grad_placements=grads,
                     device_mesh=args[0].device_mesh)(*args)


def apply_attention_decode(cfg: ModelConfig, p, x: torch.Tensor,
                           cache: Dict[str, torch.Tensor], *,
                           window: Optional[int] = None):
    """One-token decode step.  x: [B, 1, d]; cache: dict(k, v, length)
    with ``length`` a scalar int32 tensor (tokens so far, the whole batch).

    Window layers keep a ring buffer of ``smax`` slots (``slot = length %
    smax``); attention is order-free and RoPE is applied before caching.
    Other layers write slot ``length``, clamped to the last slot as the
    reference's ``dynamic_update_slice`` clamps it.  On a placed decode
    cell (DTensor caches, ``length`` replicated) each rank writes and
    attends its own cache blocks (:func:`_decode_attend`).
    """
    b = x.shape[0]
    h = norm_apply(cfg, p["norm"], x)
    q, k, v = _qkv(cfg, p, h)                    # [B, H, 1, hd]
    length = cache["length"]
    n = length.to_local() if isinstance(length, DTensor) else length
    positions = n.to(torch.int32).expand(b, 1)
    q, k = _rope_qk(cfg, q, k, positions)
    ck, cv = cache["k"], cache["v"]
    o = _decode_attend(q, k, v, ck, cv, n, ring=window is not None)
    out = _heads_out(o[:, :, None], p["wo"])     # [B, 1, d]
    return (shard(x + out, ("batch", None, None)),
            {"k": ck, "v": cv, "length": length + 1})


def _decode_attend(q, k, v, ck, cv, length: torch.Tensor, *, ring: bool):
    """Writes the step's k and v [B, Hkv, 1, hd] into the caches ck, cv
    [B, Hkv, smax, hd] in place at the step's slot, then attends q
    [B, Hq, 1, hd] over the valid slots -> [B, Hq, hd].  ``length`` is a
    plain scalar tensor.

    On DTensor caches each rank works on its blocks: q, k and v are laid
    out by the caches' batch and heads blocks (where the model axis does
    not split the KV heads, it splits no heads, so each block keeps whole
    GQA groups, as :func:`_attention`), and whole over a mesh dim that
    splits the cache's slots ("seq" over "data", ``long_500k``'s layout).
    There only the rank whose block holds the slot writes, and the ranks'
    partial attentions merge over that dim (``decode_attention``'s
    ``all_reduce``)."""
    smax = ck.shape[2]
    slot = (length % smax if ring else length.clamp(max=smax - 1)).long()
    valid = torch.minimum(length + 1, torch.full_like(length, smax))
    placed, split = isinstance(ck, DTensor), []
    if placed:
        mesh = ck.device_mesh
        split = [i for i, pl in enumerate(ck.placements) if pl.is_shard(2)]
        pq = tuple(Replicate() if pl.is_shard(2) else pl
                   for pl in ck.placements)
        q, k, v = (t.redistribute(mesh, pq).to_local() for t in (q, k, v))
        ck, cv = ck.to_local(), cv.to_local()
    q, lengths = q[:, :, 0], valid.expand(q.shape[0])
    if not split:
        ck.index_copy_(2, slot.reshape(1), k.to(ck.dtype))
        cv.index_copy_(2, slot.reshape(1), v.to(cv.dtype))
        o = decode_attention(q, ck, cv, lengths)
    else:
        (dim,) = split
        block = ck.shape[2]
        start = mesh.get_coordinate()[dim] * block
        mine = (slot >= start) & (slot < start + block)
        idx = (slot - start).clamp(0, block - 1).reshape(1)
        for c, new in ((ck, k), (cv, v)):
            c.index_copy_(2, idx, torch.where(mine, new.to(c.dtype),
                                              c.index_select(2, idx)))
        o = decode_attention(
            q, ck, cv, lengths - start,
            all_reduce=lambda t, op: funcol.all_reduce(t, op, (mesh, dim)))
    return DTensor.from_local(o, mesh, pq, run_check=False) if placed else o


def attn_cache_spec(cfg: ModelConfig, b: int, s: int,
                    window: Optional[int] = None,
                    dtype: torch.dtype = torch.bfloat16
                    ) -> Dict[str, CacheSpec]:
    smax = min(s, window) if window else s
    shape = (b, cfg.n_kv_heads, smax, cfg.hd)
    return {"k": (shape, dtype), "v": (shape, dtype),
            "length": ((), torch.int32)}


# ---------------------------------------------------------------------------
# Dense MLP (SwiGLU / GeGLU / GELU)
# ---------------------------------------------------------------------------

def init_mlp(cfg: ModelConfig, init: Init, d_ff: Optional[int] = None,
             lead: Sequence[int] = ()):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    lead = tuple(lead)
    p = dict(w_up=init.normal(lead + (d, f)),
             w_down=init.normal(lead + (f, d)),
             norm=init_norm(cfg, init, lead=lead))
    if cfg.act in ("silu", "geglu"):
        p["w_gate"] = init.normal(lead + (d, f))
    return p


def mlp_specs(cfg: ModelConfig) -> Specs:
    s = dict(w_up=("embed_fsdp", "mlp"), w_down=("mlp", "embed_fsdp"),
             norm=norm_specs(cfg))
    if cfg.act in ("silu", "geglu"):
        s["w_gate"] = ("embed_fsdp", "mlp")
    return s


def apply_mlp(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    h = norm_apply(cfg, p["norm"], x)
    up = _mm(h, shard(p["w_up"], (None, "mlp")))
    if cfg.act == "silu":          # SwiGLU
        up = F.silu(_mm(h, shard(p["w_gate"], (None, "mlp")))) * up
    elif cfg.act == "geglu":       # gemma GeGLU
        up = _gelu(_mm(h, shard(p["w_gate"], (None, "mlp")))) * up
    else:                          # plain GELU (whisper)
        up = _gelu(up)
    up = shard(up, ("batch", None, "mlp"))
    down = _mm(up, shard(p["w_down"], ("mlp", None)))
    return shard(x + down, ("batch", None, None))


# ---------------------------------------------------------------------------
# MoE (sort-based capacity dispatch; EP or TP sharding strategy)
#
# Two paths, as in the reference:
#   * apply_moe_spmd      — one program: a global argsort and a capacity
#     scatter over all E experts.
#   * apply_moe_shardmap  — explicit MoE parallelism over a DeviceMesh.
#     Each rank takes its batch block and its slice of the experts (EP:
#     E/|model| whole experts; TP: every expert's ff dim cut |model| ways),
#     routes locally, runs its expert products, and one all-reduce over
#     "model" sums the partial outputs.
# Both run _moe_local_compute: the spmd path is its one-rank case (rank 0,
# all E experts), which the reference's own test holds bit for bit.
# Routing, the sort, the scatter into the capacity buffer, the expert
# products and the weighted scatter-add are plain PyTorch on every device:
# the reference computes them outside any Pallas kernel.
#
# On DTensors (a placed cell) both keep their semantics: the shard_map
# path runs _moe_local_compute on each rank's blocks laid out as the
# reference's in_specs (_moe_shardmap_placed); the spmd path routes all T
# tokens of the global batch, as XLA's partitioner keeps one program's
# semantics, and runs the expert products on the expert or ff blocks at
# the reference's shard sites (_moe_spmd_placed).
# ---------------------------------------------------------------------------

def init_moe(cfg: ModelConfig, init: Init, lead: Sequence[int] = ()):
    """``router [d, E]``, ``w_gate``/``w_up [E, d, f]``, ``w_down
    [E, f, d]`` and the pre-norm, as the reference stores them."""
    d, f, e = cfg.d_model, cfg.expert_d_ff, cfg.n_experts
    lead = tuple(lead)
    return dict(router=init.normal(lead + (d, e)),
                w_gate=init.normal(lead + (e, d, f)),
                w_up=init.normal(lead + (e, d, f)),
                w_down=init.normal(lead + (e, f, d)),
                norm=init_norm(cfg, init, lead=lead))


def _moe_axes(cfg: ModelConfig):
    """(the expert dim's logical axis, the ff dim's): EP shards the
    expert dim, TP the within-expert ff dim."""
    tp = cfg.moe_strategy == "tp"
    return (None if tp else "experts"), ("expert_mlp" if tp else None)


def moe_specs(cfg: ModelConfig) -> Specs:
    e_axis, ff_axis = _moe_axes(cfg)
    return dict(router=(None, None),
                w_gate=(e_axis, "embed_fsdp", ff_axis),
                w_up=(e_axis, "embed_fsdp", ff_axis),
                w_down=(e_axis, ff_axis, "embed_fsdp"),
                norm=norm_specs(cfg))


class MoERoute(NamedTuple):
    """One MoE layer's routing of T tokens to top-k of E experts, slotted
    into the capacity buffers of ``n_local`` of them (all E but under the
    shard_map path's expert split)."""
    gate_w: torch.Tensor      # [T, k] float32, renormalised over the k
    idx: torch.Tensor         # [T, k] int64 expert ids, best first
    aux: torch.Tensor         # [] float32 Switch load-balance loss
    capacity: int             # slots an expert's buffer keeps
    order: torch.Tensor       # [T*k] stable argsort of the local ids
    sorted_e: torch.Tensor    # [T*k] local expert of each sorted
    #                           assignment; ``n_local`` = another rank's
    pos: torch.Tensor         # [T*k] its slot; ``capacity`` = not kept
    n_local: int              # experts kept, ids from 0

    def dropped(self) -> int:
        """Kept experts' assignments past their capacity (output 0)."""
        return int(((self.pos == self.capacity)
                    & (self.sorted_e < self.n_local)).sum())


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis.  On an exact tie the lower
    index comes first in the reference; ``torch.topk`` promises no order
    among equal values, so the port takes the first k of a stable
    descending sort, which keeps equal probabilities in index order."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _count(ids: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """How often each of ``0 .. n - 1`` occurs in ``ids``: a scatter-add
    of ones into ``zeros((n,))``, the reference's ``.at[ids].add(1)``.
    The values of ``torch.bincount(ids, minlength=n)``, whose length
    depends on the data (fake tensors refuse it, DTensor has no rule for
    it); this one's shape is static."""
    return torch.zeros((n,), dtype=dtype, device=ids.device).scatter_add(
        0, ids, torch.ones_like(ids, dtype=dtype))


def moe_route(cfg: ModelConfig, router: torch.Tensor, h: torch.Tensor,
              lo: int = 0, n_local: Optional[int] = None) -> MoERoute:
    """Top-k routing and capacity slots of the normed tokens h [T, d].

    ``lo``/``n_local`` keep the experts ``lo .. lo + n_local - 1``,
    renumbered from 0 (a rank's experts under the shard_map path); the
    other assignments go to a trash expert ``n_local`` and no slot.  The
    default keeps all E."""
    t = h.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    n_local = e if n_local is None else n_local
    logits = h @ router.to(h.dtype)                        # [T, E]
    probs = torch.softmax(logits.float(), -1)
    gate_w, idx = _top_k(probs, k)                         # [T, k]
    gate_w = gate_w / gate_w.sum(-1, keepdim=True)
    flat_e = idx.reshape(-1)                               # [T*k]
    # load-balance aux (Switch): E * sum_e(frac_tokens_e * mean_prob_e)
    frac = _count(flat_e, e, torch.float32) / (t * k)
    aux = e * torch.sum(frac * probs.mean(0))
    # the reference's formula: the integer // before the float multiply
    capacity = int(t * k // e * cfg.capacity_factor) + 1
    le = flat_e - lo
    le = torch.where((le >= 0) & (le < n_local), le,
                     torch.full_like(le, n_local))         # trash expert
    order = torch.argsort(le, stable=True)                 # jnp.argsort
    sorted_e = le[order]
    counts = _count(sorted_e, n_local + 1, torch.int64)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(t * k, device=h.device) - starts[sorted_e]
    pos = torch.where((rank < capacity) & (sorted_e < n_local), rank,
                      torch.full_like(rank, capacity))     # overflow slot
    return MoERoute(gate_w, idx, aux, capacity, order, sorted_e, pos,
                    n_local)


def apply_moe(cfg: ModelConfig, p, x: torch.Tensor):
    """The MoE layer -> (y, aux).  A ``moe_impl="shardmap"`` config takes
    the shard_map path over a mesh with a "model" axis that its strategy
    can split over (TP always, EP when |model| divides E), as the
    reference decides; else :func:`apply_moe_spmd`.  The mesh is a placed
    x's own (:func:`_moe_shardmap_placed`), or that of a :func:`use_mesh`
    block over whole tensors (:func:`apply_moe_shardmap`)."""
    placed = isinstance(x, DTensor)
    if cfg.moe_impl == "shardmap":
        mesh = x.device_mesh if placed else current_mesh()
        ok = mesh is not None and "model" in mesh_axes(mesh) and (
            cfg.moe_strategy == "tp"                      # ff-sliced experts
            or cfg.n_experts % mesh_axis_sizes(mesh)["model"] == 0)
        if ok:
            return (_moe_shardmap_placed(cfg, p, x) if placed
                    else apply_moe_shardmap(cfg, p, x, mesh))
    return apply_moe_spmd(cfg, p, x)


def _moe_dispatch(cfg: ModelConfig, router: torch.Tensor, h: torch.Tensor,
                  lo: int, n_local: int):
    """Route ``h`` [t, d] against experts ``lo .. lo + n_local - 1`` and
    scatter the kept assignments into an [n_local, C, d] buffer -> (the
    route, each sorted assignment's token, its expert's buffer row, the
    buffer).  Slot C of the scatter takes every overflow and every other
    rank's assignment, and is cut off."""
    t, d = h.shape
    r = moe_route(cfg, router, h, lo, n_local)
    src = r.order // cfg.top_k                             # token index
    ex = r.sorted_e.clamp(max=n_local - 1)                 # trash: slot C
    buf = h.new_zeros((n_local, r.capacity + 1, d))
    buf[ex, r.pos] = h[src]
    return r, src, ex, buf[:, :r.capacity]


def _moe_experts(cfg: ModelConfig, p, buf: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU on their buffers [E, C, d] as batched
    products.  On DTensors at the reference's ``shard`` sites: the
    buffers and outputs over the expert dim (EP), the activation also
    over the ff dim (TP), each weight gathered over its FSDP dim for the
    product; on plain tensors the constraints are no-ops."""
    e_ax, f_ax = _moe_axes(cfg)
    dt = buf.dtype
    buf = shard(buf, (e_ax, None, None))
    gate = torch.einsum("ecd,edf->ecf", buf,
                        shard(p["w_gate"], (e_ax, None, f_ax)).to(dt))
    up = torch.einsum("ecd,edf->ecf", buf,
                      shard(p["w_up"], (e_ax, None, f_ax)).to(dt))
    act = shard(F.silu(gate) * up, (e_ax, None, f_ax))
    y_e = torch.einsum("ecf,efd->ecd", act,
                       shard(p["w_down"], (e_ax, f_ax, None)).to(dt))
    return shard(y_e, (e_ax, None, None))


def _moe_combine(r: MoERoute, src, ex, y_e: torch.Tensor,
                 w_sorted: torch.Tensor, t: int, k: int) -> torch.Tensor:
    """The experts' outputs read back per sorted assignment (a zero row
    padded on at slot C, so an assignment without a slot contributes 0),
    weighted and added per token in the reference's order -> [t, d]."""
    y_e = F.pad(y_e, (0, 0, 0, 1))                         # slot C reads 0
    gathered = y_e[ex, r.pos]                              # [t*k, d]
    return combine_in_order(w_sorted[:, None] * gathered, src, t, k)


def _moe_local_compute(cfg: ModelConfig, p_local, h: torch.Tensor,
                       my_rank: int, e_local: int):
    """Route ``h`` [t, d] against this rank's ``e_local`` experts (ids
    ``my_rank * e_local`` on, whose weights ``p_local`` holds) -> (partial
    output [t, d], aux).  Local math, no collectives.

    Assignments are sorted by local expert, scattered into an
    [e_local, C + 1, d] buffer (:func:`_moe_dispatch`), run through the
    experts as batched products, read back and combined by a weighted
    scatter-add over tokens in the reference's order
    (:func:`_moe_combine`, :func:`combine_in_order`).  The capacity C
    comes from the local token count t."""
    t = h.shape[0]
    # three profiler ranges (no cost unless a profiler records): routing
    # and the scatter, the expert products, the gather and the combine
    with record_function("moe.dispatch"):
        r, src, ex, buf = _moe_dispatch(cfg, p_local["router"], h,
                                        my_rank * e_local, e_local)
    with record_function("moe.experts"):
        y_e = _moe_experts(cfg, p_local, buf)
    with record_function("moe.combine"):
        w_sorted = r.gate_w.reshape(-1)[r.order].to(h.dtype)
        out = _moe_combine(r, src, ex, y_e, w_sorted, t, cfg.top_k)
    return out, r.aux


def combine_in_order(terms: torch.Tensor, src: torch.Tensor, t: int,
                     k: int) -> torch.Tensor:
    """``zeros((t, d)).at[src].add(terms)`` as the reference's scatter
    computes it: each token's k terms added one at a time, in the order
    they come in ``terms``, rounding to ``terms``' dtype after every add.

    ``src`` [t*k] names each term's token, every token exactly k times.
    A stable sort gives each token its k term positions in order; then k
    gathers and k adds.  The order is fixed on every device, so the sum is
    the same bits run after run (``index_add`` sums by atomics on a card
    and in float32 on the CPU); each gather's backward scatters to
    distinct rows."""
    perm = torch.argsort(src, stable=True).reshape(t, k)
    out = terms.new_zeros((t, terms.shape[1]))
    for j in range(k):
        out = out + terms[perm[:, j]]
    return out


def _batch_axes(b: int, sizes: Dict[str, int]) -> Tuple[str, ...]:
    """The data axes ("pod", "data") that split a batch of ``b`` under
    the shard_map path: the major ones dropped first until their product
    divides ``b`` (e.g. none at decode b = 1), as the reference does."""
    axes = tuple(a for a in ("pod", "data") if a in sizes)
    while axes and b % math.prod(sizes[a] for a in axes):
        axes = axes[1:]
    return axes


def apply_moe_shardmap(cfg: ModelConfig, p, x: torch.Tensor, mesh):
    """Explicit MoE parallelism over a ``DeviceMesh`` with a "model" axis:
    one all-reduce over "model" a layer -> (this rank's batch block of
    x + y, aux).

    ``x`` [B, S, d] and ``p`` are whole on every rank.  The batch splits
    over the data axes ("pod", "data") that divide B (:func:`_batch_axes`);
    the rank takes its block, as the reference's
    ``in_specs=P(batch_axes)``, and returns it, as its ``out_specs``.

    * strategy "ep" (kimi): experts sharded over "model"; each rank keeps
      the assignments to its own E/|model| experts.
    * strategy "tp" (mixtral): every rank holds ALL experts, each cut to
      its ff slice; the expert products give partial sums over the ff dim.

    Either way one all-reduce sums the partial outputs over the "model"
    group (counted in ``apply_moe_shardmap.all_reduces``) and a second one
    averages aux over it.

    Gradients are those of the reference's ``jax.grad`` over the same
    mesh: every rank of a "model" group holds the gradient of its batch
    block's loss, which each rank computes whole.  So the all-reduce passes
    its cotangent through, and the tensors replicated over "model" that
    feed the rank's own experts (the normed block and the router) sum
    their cotangents over the group on the way back.  A rank's expert
    slices get their own gradient; x gets it on its block's rows; the
    router's and the norm's are its block's share, summed over the data
    axes as a data-parallel step sums them.
    """
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"apply_moe_shardmap runs over a DeviceMesh, not "
                        f"{type(mesh).__name__} (a MeshShape has no ranks)")
    b, s, d = x.shape
    e, f = cfg.n_experts, cfg.expert_d_ff
    sizes = mesh_axis_sizes(mesh)
    msize = sizes["model"]
    tp = cfg.moe_strategy == "tp"
    e_local = e if tp else e // msize
    if (f if tp else e) % msize:
        raise ValueError(f"|model| = {msize} does not divide "
                         f"{'expert_d_ff' if tp else 'n_experts'}")
    batch_axes = _batch_axes(b, sizes)
    coord = dict(zip(mesh_axes(mesh), mesh.get_coordinate()))
    blk = 0
    for a in batch_axes:                                   # major first
        blk = blk * sizes[a] + coord[a]
    bl = b // math.prod(sizes[a] for a in batch_axes)
    x_blk = x[blk * bl:(blk + 1) * bl]
    m = coord["model"]
    if tp:
        fl = f // msize
        cut = slice(m * fl, (m + 1) * fl)
        w = (p["w_gate"][:, :, cut], p["w_up"][:, :, cut],
             p["w_down"][:, cut, :])
    else:
        cut = slice(m * e_local, (m + 1) * e_local)
        w = (p["w_gate"][cut], p["w_up"][cut], p["w_down"][cut])
    group = mesh.get_group("model")
    p_local = dict(zip(("router", "w_gate", "w_up", "w_down"),
                       (_SumGradOver.apply(p["router"], group),) + w))
    h = _SumGradOver.apply(rms_norm(x_blk, p["norm"]["scale"]), group)
    out, aux = _moe_local_compute(cfg, p_local, h.reshape(bl * s, d),
                                  0 if tp else m, e_local)
    out = _AllReduceSum.apply(out, group)
    apply_moe_shardmap.all_reduces += 1
    aux = _AllReduceSum.apply(aux, group) / msize
    return x_blk + out.reshape(bl, s, d), aux


apply_moe_shardmap.all_reduces = 0


def _moe_shardmap_placed(cfg: ModelConfig, p, x: torch.Tensor):
    """The shard_map path on a placed layer: DTensor ``x`` [B, S, d] and
    parameters -> (x + y, aux), laid out as x.

    Each input is laid out as the reference's ``in_specs``: the router
    and the norm's scale whole, the experts over "model" (EP) or their ff
    dim over it (TP; an FSDP split over "data" is gathered here, the
    reference's gather at the shard_map edge), x's batch over the data
    axes of :func:`_batch_axes` and whole over "model".  Then
    :func:`_moe_local_compute` runs on each rank's blocks (``local_map``)
    with the rank's experts (its "model" coordinate under EP) and the
    capacity of its block's tokens.  Its output is partial over "model":
    one all-reduce a layer makes it whole (counted in
    ``apply_moe_shardmap.all_reduces``).

    Gradients are the reference's ``jax.grad``'s: an input whole over a
    mesh dim that splits the work ("model", and the batch's data axes)
    gets only its block's share from each rank, so its gradient is
    declared ``Partial`` there (the router, the norm's scale and x over
    "model" sum the ranks' uses, as :class:`_SumGradOver` does; the
    weights over the data axes sum the batch blocks').

    aux keeps the port's rule for several data blocks (ROADMAP Queue 3):
    each block's own, here their mean, a scalar partial over the split
    dims, so its gradient is the mean of the blocks' aux gradients, the
    reference's (whose value is the first block's)."""
    mesh = x.device_mesh
    axes, sizes = mesh_axes(mesh), mesh_axis_sizes(mesh)
    b, s, d = x.shape
    tp = cfg.moe_strategy == "tp"
    e_local = cfg.n_experts if tp else cfg.n_experts // sizes["model"]
    batch_axes = _batch_axes(b, sizes)
    mdim = axes.index("model")
    split = {mdim} | {axes.index(a) for a in batch_axes}
    w_specs = (((None, None, "model"),) * 2 + ((None, "model", None),)
               if tp else (("model", None, None),) * 3)
    specs = ((None, None),) + w_specs + ((None,), (batch_axes or None,
                                                    None, None))
    ins = [t.redistribute(mesh, placements(sp, mesh)) for t, sp in zip(
        (p["router"], p["w_gate"], p["w_up"], p["w_down"],
         p["norm"]["scale"], x), specs)]
    grads = tuple(tuple(Partial() if pl.is_replicate() and i in split
                        else pl for i, pl in enumerate(t.placements))
                  for t in ins)
    n = math.prod(mesh.size(i) for i in split)
    out_pl = [Partial() if i == mdim else pl
              for i, pl in enumerate(ins[-1].placements)]
    aux_pl = [Partial() if i in split else Replicate()
              for i in range(mesh.ndim)]
    my_rank = 0 if tp else mesh.get_coordinate()[mdim]

    def local(router, w_gate, w_up, w_down, scale, x_blk):
        bl, sl, _ = x_blk.shape
        h = rms_norm(x_blk, scale).reshape(bl * sl, d)
        out, aux = _moe_local_compute(
            cfg, dict(router=router, w_gate=w_gate, w_up=w_up,
                      w_down=w_down), h, my_rank, e_local)
        return out.reshape(bl, sl, d), aux / n

    out, aux = local_map(local, out_placements=(out_pl, aux_pl),
                         in_placements=tuple(t.placements for t in ins),
                         in_grad_placements=grads, device_mesh=mesh)(*ins)
    out = out.redistribute(mesh, x.placements)        # the all-reduce
    apply_moe_shardmap.all_reduces += 1
    return x + out, aux


class _AllReduceSum(torch.autograd.Function):
    """``dist.all_reduce(SUM)`` out of place.  Every rank of the group
    goes on with the same sum to the same loss, so the cotangent each rank
    holds is already the sum's: the backward passes it through."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumGradOver(torch.autograd.Function):
    """The identity on a tensor replicated over ``group`` that feeds
    rank-local work; the backward sums the cotangents over the group, so
    each rank gets the gradient of every rank's use of it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def apply_moe_spmd(cfg: ModelConfig, p, x: torch.Tensor):
    """Top-k MoE with sort-based capacity dispatch over all E experts ->
    (x + y, aux): :func:`_moe_local_compute` as rank 0 of one, or
    :func:`_moe_spmd_placed` on a placed layer."""
    b, s, d = x.shape
    h = norm_apply(cfg, p["norm"], x).reshape(b * s, d)
    if isinstance(h, DTensor):
        out, aux = _moe_spmd_placed(cfg, p, h)
        out = shard(out.reshape(b, s, d), ("batch", None, None))
    else:
        out, aux = _moe_local_compute(cfg, p, h, 0, cfg.n_experts)
        out = out.reshape(b, s, d)
    return x + out, aux


def _moe_spmd_placed(cfg: ModelConfig, p, h: torch.Tensor):
    """:func:`apply_moe_spmd` on a placed layer's normed tokens, DTensor h
    [T, d] -> (the output [T, d] and aux, whole on every rank), with one
    program's semantics, as XLA's partitioner keeps them: the top-k, the
    capacity ``int(T*k//E*cf)+1`` and the stable sort over all T tokens
    of the global batch.  The tokens are gathered, and each rank routes
    them all and scatters them into the whole buffer (``local_map`` on
    replicated blocks: every rank computes the same, so no gradient is a
    partial sum); the expert products run as DTensor products at the
    reference's ``shard`` sites (:func:`_moe_experts`: EP on each rank's
    experts, TP on its ff slice, partial over "model" until the output's
    constraint); each rank reads the outputs back and combines them whole."""
    mesh = h.device_mesh
    whole = [Replicate()] * mesh.ndim
    t = h.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    routed = {}

    def dispatch(router, h):
        r, src, ex, buf = _moe_dispatch(cfg, router, h, 0, e)
        routed.update(r=r, src=src, ex=ex)
        return buf, r.gate_w.reshape(-1)[r.order].to(h.dtype), r.aux

    def combine(y_e, w_sorted):
        return _moe_combine(routed["r"], routed["src"], routed["ex"], y_e,
                            w_sorted, t, k)

    with record_function("moe.dispatch"):
        buf, w_sorted, aux = local_map(
            dispatch, out_placements=(whole, whole, whole),
            in_placements=(whole, whole), device_mesh=mesh)(
                p["router"].redistribute(mesh, whole),
                h.redistribute(mesh, whole))
    with record_function("moe.experts"):
        y_e = _moe_experts(cfg, p, buf).redistribute(mesh, whole)
    with record_function("moe.combine"):
        out = local_map(combine, out_placements=whole,
                        in_placements=(whole, whole),
                        device_mesh=mesh)(y_e, w_sorted)
    return out, aux


# ---------------------------------------------------------------------------
# Mamba2 block (zamba2 backbone)
# ---------------------------------------------------------------------------

def init_mamba2(cfg: ModelConfig, init: Init, lead: Sequence[int] = ()):
    d, h = cfg.d_model, cfg.ssm_heads
    g, n = cfg.ssm_groups, cfg.ssm_state
    inner = h * cfg.ssm_head_dim
    lead = tuple(lead)
    return dict(
        w_in=init.normal(lead + (d, 2 * inner + 2 * g * n + h)),
        conv_w=init.normal(lead + (cfg.conv_kernel, inner + 2 * g * n)),
        A_log=init.zeros(lead + (h,)),
        D=init.ones(lead + (h,)),
        dt_bias=init.zeros(lead + (h,)),
        norm=init_norm(cfg, init, lead=lead),
        gate_norm=init_norm(cfg, init, inner, lead=lead),
        w_out=init.normal(lead + (inner, d)),
    )


def mamba2_specs(cfg: ModelConfig) -> Specs:
    return dict(w_in=("embed_fsdp", "mlp"), conv_w=(None, None),
                A_log=(None,), D=(None,), dt_bias=(None,),
                norm=norm_specs(cfg), gate_norm=norm_specs(cfg),
                w_out=("mlp", "embed_fsdp"))


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv.  x: [B, S, C]; w: [K, C].

    Returns (y, new_state) where state is the last K-1 inputs."""
    k = w.shape[0]
    if state is None:                  # zeros laid out as x (a DTensor too)
        state = torch.zeros_like(x[:, :1]).expand(-1, k - 1, -1)
    dt = torch.promote_types(state.dtype, x.dtype)
    xp = torch.cat([state.to(dt), x.to(dt)], dim=1)
    ys = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k))
    return ys, xp[:, -(k - 1):]


def _mamba_split(cfg: ModelConfig, p, x: torch.Tensor, *,
                 step: bool = False):
    """``x @ w_in`` cut into z, x, B, C and dt.

    On DTensors the product is made whole over "model", and each piece
    takes its layout after the cut: ``w_in``'s columns pack z | x | B | C
    | dt, bounds that an even cut of the columns over "model" does not
    keep (zamba2-7b: 14,576 columns, 7,288 a rank at 2, 911 at 16).  A
    sequence gathers ``w_in`` (d x 14,576, far less than a train or
    prefill cell's activation [B, S, 14,576]) and each model rank makes the
    whole product; a decode ``step`` gathers its one token's activation
    instead, so that a step in the serve layout gathers no parameter."""
    g, n = cfg.ssm_groups, cfg.ssm_state
    inner = cfg.ssm_heads * cfg.ssm_head_dim
    if step:
        zxbcdt = shard(_mm(x, p["w_in"]), ("batch", None, None))
    else:
        zxbcdt = _mm(x, shard(p["w_in"], (None, None)))
    return torch.split(zxbcdt, [inner, inner, g * n, g * n, cfg.ssm_heads],
                       dim=-1)


def _ssd_heads(cfg: ModelConfig, x: torch.Tensor):
    """The logical axis of the SSD's heads on x's mesh: "heads", or None
    where the mesh does not split G > 1 groups (B and C go whole then, and
    a block of heads would read groups that are not its own)."""
    if isinstance(x, DTensor) and cfg.ssm_groups > 1 and resolve(
            ("heads",), x.device_mesh, (cfg.ssm_groups,))[0] is None:
        return None
    return "heads"


def apply_mamba2(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """The full-sequence Mamba2 layer.  On DTensors the SSD runs on each
    rank's block of batch and heads (:func:`_on_blocks`); B and C go
    whole over "model" where it does not split their groups (zamba2: one
    group)."""
    b, s, d = x.shape
    h_heads, g, n = cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_state
    p_dim = cfg.ssm_head_dim
    ha = _ssd_heads(cfg, x)
    hidden = norm_apply(cfg, p["norm"], x)
    z, xc, Bc, Cc, dt = _mamba_split(cfg, p, hidden)
    conv_in = torch.cat([xc, Bc, Cc], -1)
    conv_out, _ = _causal_conv(conv_in, p["conv_w"])
    conv_out = F.silu(conv_out)
    xc, Bc, Cc = torch.split(conv_out, [xc.shape[-1], Bc.shape[-1],
                                        Cc.shape[-1]], dim=-1)
    xh = shard(xc.reshape(b, s, h_heads, p_dim), ("batch", None, ha, None))
    Bm = shard(Bc.reshape(b, s, g, n), ("batch", None, "heads", None))
    Cm = shard(Cc.reshape(b, s, g, n), ("batch", None, "heads", None))
    dt = shard(_softplus(dt + p["dt_bias"]), ("batch", None, ha))  # [B,S,H]
    A = shard(-torch.exp(p["A_log"].float()), (ha,))
    y = _on_blocks(ssd, (xh, dt, A, Bm, Cm))                # [B,S,H,P]
    y = y + p["D"][None, None, :, None] * xh
    y = y.reshape(b, s, h_heads * p_dim)
    z = shard(z, ("batch", None, ha), sizes=(b, s, h_heads))
    y = rms_norm(y * F.silu(z), p["gate_norm"]["scale"])
    w_out = shard(p["w_out"], (ha, None), sizes=(h_heads, d))
    return shard(x + _mm(y, w_out), ("batch", None, None))


def apply_mamba2_decode(cfg: ModelConfig, p, x: torch.Tensor,
                        cache: Dict[str, torch.Tensor]):
    """x: [B, 1, d]; cache: dict(conv [B,K-1,C], ssm [B,H,N,P]).  On a
    placed decode cell each rank steps its block of the SSM state (batch
    and heads); the conv state and the in-projection's pieces go whole
    over "model"."""
    b, _, d = x.shape
    h_heads, g, n = cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_state
    p_dim = cfg.ssm_head_dim
    ha = _ssd_heads(cfg, x)
    hidden = norm_apply(cfg, p["norm"], x)
    z, xc, Bc, Cc, dt = _mamba_split(cfg, p, hidden, step=True)
    conv_in = torch.cat([xc, Bc, Cc], -1)
    conv_out, conv_state = _causal_conv(conv_in, p["conv_w"], cache["conv"])
    conv_out = F.silu(conv_out)
    xc, Bc, Cc = torch.split(conv_out, [xc.shape[-1], Bc.shape[-1],
                                        Cc.shape[-1]], dim=-1)
    xh = shard(xc.reshape(b, h_heads, p_dim), ("batch", ha, None))
    dt = shard(_softplus(dt + p["dt_bias"]).reshape(b, h_heads),
               ("batch", ha))
    A = shard(-torch.exp(p["A_log"].float()), (ha,))
    Bm = shard(Bc.reshape(b, g, n), ("batch", "heads", None))
    Cm = shard(Cc.reshape(b, g, n), ("batch", "heads", None))
    y, ssm = _on_blocks(ssd_decode, (xh, dt, A, Bm, Cm, cache["ssm"]),
                        (0, 5))
    y = y + p["D"][None, :, None] * xh
    y = y.reshape(b, 1, h_heads * p_dim)
    z = shard(z, ("batch", None, ha), sizes=(b, 1, h_heads))
    y = rms_norm(y * F.silu(z), p["gate_norm"]["scale"])
    w_out = shard(p["w_out"], (ha, None), sizes=(h_heads, d))
    return (shard(x + _mm(y, w_out), ("batch", None, None)),
            {"conv": conv_state, "ssm": ssm})


def mamba_cache_spec(cfg: ModelConfig, b: int,
                     dtype: torch.dtype = torch.bfloat16
                     ) -> Dict[str, CacheSpec]:
    h, p_dim = cfg.ssm_heads, cfg.ssm_head_dim
    c = h * p_dim + 2 * cfg.ssm_groups * cfg.ssm_state
    return {"conv": ((b, cfg.conv_kernel - 1, c), dtype),
            "ssm": ((b, h, cfg.ssm_state, p_dim), torch.float32)}


# ---------------------------------------------------------------------------
# RWKV6 block
# ---------------------------------------------------------------------------

def init_rwkv6(cfg: ModelConfig, init: Init, lead: Sequence[int] = ()):
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    lora = 32
    lead = tuple(lead)
    return dict(
        norm_t=init_norm(cfg, init, lead=lead),
        norm_c=init_norm(cfg, init, lead=lead),
        mu=init.normal(lead + (5, d), std=0.2),      # r,k,v,w,g shifts
        wr=init.normal(lead + (d, d)),
        wk=init.normal(lead + (d, d)),
        wv=init.normal(lead + (d, d)),
        wg=init.normal(lead + (d, d)),
        w_base=init.zeros(lead + (d,)),
        w_lora_a=init.normal(lead + (d, lora)),
        w_lora_b=init.normal(lead + (lora, d)),
        bonus=init.normal(lead + (d // hd, hd)),
        ln_x=init.ones(lead + (d,)),
        wo=init.normal(lead + (d, d)),
        mu_c=init.normal(lead + (2, d), std=0.2),    # channel-mix shifts
        ck=init.normal(lead + (d, cfg.d_ff)),
        cv=init.normal(lead + (cfg.d_ff, d)),
        cr=init.normal(lead + (d, d)),
    )


def rwkv6_specs(cfg: ModelConfig) -> Specs:
    return dict(
        norm_t=norm_specs(cfg), norm_c=norm_specs(cfg), mu=(None, None),
        wr=("embed_fsdp", "heads"), wk=("embed_fsdp", "heads"),
        wv=("embed_fsdp", "heads"), wg=("embed_fsdp", "heads"),
        w_base=(None,), w_lora_a=(None, None), w_lora_b=(None, None),
        bonus=(None, None), ln_x=(None,), wo=("heads", "embed_fsdp"),
        mu_c=(None, None), ck=("embed_fsdp", "mlp"),
        cv=("mlp", "embed_fsdp"), cr=("embed_fsdp", None))


def _token_shift(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """prev-token stream: [last, x_0 .. x_{S-2}]."""
    return torch.cat([last[:, None], x[:, :-1]], dim=1)


def _rwkv_time_mix(cfg: ModelConfig, p, x: torch.Tensor,
                   x_prev: torch.Tensor, state=None):
    """The time mixing -> (its output, the new WKV state of a decode step
    or None).  On DTensors r, k, v, w and g are laid out by heads (judged
    on the head count), the WKV runs on each rank's block of batch and
    heads (:func:`_on_blocks`), the whole-d norm ``ln_x`` reduces over
    "model", and the output projection leaves partial sums over it."""
    b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    nh = d // hd

    def mix(i):
        return x + (x_prev - x) * p["mu"][i]

    def proj(i, name):
        return _mm(mix(i), shard(p[name], (None, "heads"), sizes=(d, nh)))

    r, k, v, g = proj(0, "wr"), proj(1, "wk"), proj(2, "wv"), proj(4, "wg")
    w = p["w_base"] + _mm(torch.tanh(_mm(mix(3), p["w_lora_a"])),
                          p["w_lora_b"])
    # the double exp in float32, the decay cast back before the kernel
    w = torch.exp(-torch.exp(w.float())).to(x.dtype)
    w = shard(w, ("batch", None, "heads"), sizes=(b, s, nh))
    u = shard(p["bonus"], ("heads", None))

    def heads(t):
        return t.reshape(b, s, nh, hd).transpose(1, 2)

    if state is None:
        y = _on_blocks(wkv6, (heads(r), heads(k), heads(v), heads(w), u))
        new_state = None
    else:
        def step(t):
            return t.reshape(b, nh, hd)

        y, new_state = _on_blocks(
            wkv6_decode, (step(r), step(k), step(v), step(w), u, state),
            (0, 5))
        y = y[:, :, None]                              # [B, H, 1, hd]
    y = y.transpose(1, 2).reshape(b, s, d)
    # the reference normalises over the whole d, not per head
    y = rms_norm(y, p["ln_x"]) * F.silu(g)
    return _mm(y, shard(p["wo"], ("heads", None), sizes=(nh, d))), new_state


def _rwkv_channel_mix(cfg: ModelConfig, p, x: torch.Tensor,
                      x_prev: torch.Tensor) -> torch.Tensor:
    def mix(i):
        return x + (x_prev - x) * p["mu_c"][i]

    k = torch.square(F.relu(_mm(mix(0), shard(p["ck"], (None, "mlp")))))
    r = torch.sigmoid(_mm(mix(1), shard(p["cr"], (None, None))))
    kv = _mm(shard(k, ("batch", None, "mlp")), shard(p["cv"], ("mlp", None)))
    return r * shard(kv, ("batch", None, None))


def apply_rwkv6(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence RWKV6 layer; the token shift starts from zeros."""
    h = norm_apply(cfg, p["norm_t"], x)
    last = torch.zeros_like(h[:, 0])
    y, _ = _rwkv_time_mix(cfg, p, h, _token_shift(h, last))
    x = shard(x + y, ("batch", None, None))
    h2 = norm_apply(cfg, p["norm_c"], x)
    x = x + _rwkv_channel_mix(cfg, p, h2, _token_shift(h2, last))
    return shard(x, ("batch", None, None))


def apply_rwkv6_decode(cfg: ModelConfig, p, x: torch.Tensor,
                       cache: Dict[str, torch.Tensor]):
    """x: [B, 1, d]; cache: dict(last_t, last_c [B,d], wkv [B,H,K,V]).
    ``last_t`` and ``last_c`` hold the normed inputs of the two mixes.  On
    a placed decode cell each rank steps its block of the WKV state (batch
    and heads); ``last_t`` and ``last_c`` go by batch."""
    h = norm_apply(cfg, p["norm_t"], x)
    y, wkv_state = _rwkv_time_mix(cfg, p, h, cache["last_t"][:, None],
                                  state=cache["wkv"])
    x = shard(x + y, ("batch", None, None))
    h2 = norm_apply(cfg, p["norm_c"], x)
    x = x + _rwkv_channel_mix(cfg, p, h2, cache["last_c"][:, None])
    return (shard(x, ("batch", None, None)),
            {"last_t": h[:, 0], "last_c": h2[:, 0], "wkv": wkv_state})


def rwkv_cache_spec(cfg: ModelConfig, b: int,
                    dtype: torch.dtype = torch.bfloat16
                    ) -> Dict[str, CacheSpec]:
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    nh = d // hd
    return {"last_t": ((b, d), dtype), "last_c": ((b, d), dtype),
            "wkv": ((b, nh, hd, hd), torch.float32)}
