"""Decoder-only LM: dense / GQA / gemma local:global / MoE / Mamba2 hybrid
(zamba2) / RWKV6 (Finch) / the VLM backbone (qwen2-vl, M-RoPE).

Port of ``repro.models.lm``.  The layer stack is ``repeats`` x ``unit``
(+ tail), where ``unit`` is the repeating pattern (gemma3: 5 local + 1
global; zamba2: 6 Mamba2 layers; rwkv6: one RWKV6 layer).  Each unit
position's parameters are stacked over ``repeats`` (the reference's
layout, so converted weights compare leaf for leaf); the reference's
``lax.scan`` over ``repeats`` becomes a Python loop.  Zamba2's *shared*
attention block (the same weights every unit) runs after each unit, and
its per-invocation KV caches are stacked over ``repeats``.

Entry points::

    init(generator, dtype, device)     -> params
    param_specs()                      -> the reference's logical axes
    train_loss(params, batch)          -> next-token cross-entropy + 0.01 aux
    prefill(params, tokens, vision_embeds, mrope_positions)
                                       -> last-position logits [B, vocab]
    decode_step(params, caches, tokens) -> (logits [B, vocab], caches)

``aux`` is the MoE layers' load-balance loss (0 for the other kinds).  The
VLM inputs, as in the reference: ``vision_embeds`` [B, V, d] go in front of
the token embeddings, and ``mrope_positions`` [3, B, V + S] rotate the
repeats' attention by M-RoPE (the tail's layers take plain RoPE).

On a CUDA device ``train_loss`` and ``prefill`` run the flash-attention,
Mamba2 SSD and RWKV6 WKV CUDA kernels (their gradients recompute the plain
versions, as the reference's ``custom_vjp`` does); ``decode_step`` is
plain PyTorch (one token against the caches), and so is the MoE dispatch.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.parallel.sharding import replicate_like, shard
from .blocks import (
    apply_attention, apply_attention_decode, apply_mamba2,
    apply_mamba2_decode, apply_mlp, apply_moe, apply_rwkv6,
    apply_rwkv6_decode, attention_specs, attn_cache_spec, init_attention,
    init_mamba2, init_mlp, init_moe, init_norm, init_rwkv6, mamba2_specs,
    mamba_cache_spec, mlp_specs, moe_specs, norm_apply, norm_specs,
    rwkv6_specs, rwkv_cache_spec,
)
from .common import Init, default_positions, log_softmax
from .config import ModelConfig

ATTN_KINDS = ("attn", "swa", "local", "global")
MOE_KINDS = ("moe", "moe_swa")


def derive_unit(cfg: ModelConfig) -> List[str]:
    if cfg.family == "ssm":
        return ["rwkv"]
    if cfg.family == "hybrid":
        return ["mamba"] * max(cfg.shared_attn_every, 1)
    if cfg.local_ratio:
        return ["local"] * cfg.local_ratio + ["global"]
    if cfg.n_experts:
        return ["moe_swa" if cfg.window else "moe"]
    return ["swa" if cfg.window else "attn"]


def _layer_kinds(cfg: ModelConfig):
    unit = derive_unit(cfg)
    repeats = cfg.n_layers // len(unit)
    tail = cfg.n_layers - repeats * len(unit)
    return unit, repeats, unit[:tail]


def _init_layer(cfg: ModelConfig, kind: str, init: Init, lead=()):
    if kind in ATTN_KINDS:
        return {"attn": init_attention(cfg, init, lead),
                "mlp": init_mlp(cfg, init, lead=lead)}
    if kind in MOE_KINDS:
        return {"attn": init_attention(cfg, init, lead),
                "moe": init_moe(cfg, init, lead=lead)}
    if kind == "mamba":
        return init_mamba2(cfg, init, lead)
    if kind == "rwkv":
        return init_rwkv6(cfg, init, lead)
    raise ValueError(kind)


def _layer_specs(cfg: ModelConfig, kind: str):
    if kind in ATTN_KINDS:
        return {"attn": attention_specs(cfg), "mlp": mlp_specs(cfg)}
    if kind in MOE_KINDS:
        return {"attn": attention_specs(cfg), "moe": moe_specs(cfg)}
    if kind == "mamba":
        return mamba2_specs(cfg)
    if kind == "rwkv":
        return rwkv6_specs(cfg)
    raise ValueError(kind)


def stack_specs(specs):
    """A layer's specs with the leading "stack" axis of a stacked tree."""
    if isinstance(specs, dict):
        return {k: stack_specs(v) for k, v in specs.items()}
    return ("stack",) + tuple(specs)


def _kind_window(cfg: ModelConfig, kind: str) -> Optional[int]:
    if kind in ("swa", "moe_swa", "local"):
        return cfg.window
    return None


def _apply_layer(cfg, kind, p, x, *, positions, mrope_positions=None):
    """One layer of the full-sequence forward -> (x, aux)."""
    aux = _zero_aux(x)
    if kind in ATTN_KINDS or kind in MOE_KINDS:
        x = apply_attention(cfg, p["attn"], x, positions=positions,
                            window=_kind_window(cfg, kind),
                            mrope_positions=mrope_positions)
        if kind in MOE_KINDS:
            return apply_moe(cfg, p["moe"], x)
        return apply_mlp(cfg, p["mlp"], x), aux
    if kind == "mamba":
        return apply_mamba2(cfg, p, x), aux
    if kind == "rwkv":
        return apply_rwkv6(cfg, p, x), aux
    raise ValueError(kind)


def _apply_layer_decode(cfg, kind, p, x, cache):
    if kind in ATTN_KINDS or kind in MOE_KINDS:
        x, new = apply_attention_decode(cfg, p["attn"], x, cache,
                                        window=_kind_window(cfg, kind))
        if kind in MOE_KINDS:
            x, _ = apply_moe(cfg, p["moe"], x)
            return x, new
        return apply_mlp(cfg, p["mlp"], x), new
    if kind == "mamba":
        return apply_mamba2_decode(cfg, p, x, cache)
    if kind == "rwkv":
        return apply_rwkv6_decode(cfg, p, x, cache)
    raise ValueError(kind)


def _layer_cache_spec(cfg, kind, b, s, dtype):
    if kind in ("attn", "global", "moe"):
        return attn_cache_spec(cfg, b, s, None, dtype)
    if kind in ("swa", "local", "moe_swa"):
        return attn_cache_spec(cfg, b, s, cfg.window, dtype)
    if kind == "mamba":
        return mamba_cache_spec(cfg, b, dtype)
    if kind == "rwkv":
        return rwkv_cache_spec(cfg, b, dtype)
    raise ValueError(kind)


def _index(tree, r: int):
    """The ``r``-th slice of every tensor of a tree stacked over repeats
    (views, so in-place cache writes land in the stack; a DTensor's slice
    is a DTensor whose local block is a view of the stack's, the stack
    dim being never sharded)."""
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


def _restack(old, given, trees):
    """Inverse of :func:`_index` over a list of per-repeat trees: a leaf
    whose every new tensor is the slice :func:`_index` gave (``given``,
    written in place) keeps ``old``'s tensor; the others are stacked
    anew."""
    if not trees:
        return old
    if isinstance(old, dict):
        return {k: _restack(old[k], [g[k] for g in given],
                            [t[k] for t in trees]) for k in old}
    if all(t is g for t, g in zip(trees, given)):
        return old
    return torch.stack(trees)


def _zero_aux(x):
    """A float32 zero beside x: replicated over x's mesh if x is a
    DTensor."""
    return replicate_like(torch.zeros((), dtype=torch.float32,
                                      device=x.device), x)


def _zeros(spec, lead, device):
    if isinstance(spec, dict):
        return {k: _zeros(v, lead, device) for k, v in spec.items()}
    shape, dtype = spec
    return torch.zeros(tuple(lead) + tuple(shape), dtype=dtype,
                       device=device)


class LM:
    """Functional model object: init / train_loss / logits / prefill /
    decode_step."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.unit, self.repeats, self.tail = _layer_kinds(cfg)

    # -- init ----------------------------------------------------------------

    def init(self, generator: Union[None, int, torch.Generator] = None,
             dtype: torch.dtype = torch.float32,
             device: DeviceLike = None, *,
             place: Optional[Callable[[torch.Tensor], Any]] = None
             ) -> Dict[str, Any]:
        """Random parameters (normal std 0.02 / zeros / ones, as the
        reference draws them) from ``generator``: a ``torch.Generator`` on
        ``device``, or an int seed (``None`` = 0).  ``device=None`` means
        ``"cuda"``; ``place`` is :class:`~.common.Init`'s."""
        dev = resolve_device(device)
        return self._init(generator, dtype, dev, place)

    def _init(self, generator, dtype, dev: torch.device, place=None):
        if dev.type != "meta" and not isinstance(generator, torch.Generator):
            generator = torch.Generator(device=dev).manual_seed(
                0 if generator is None else int(generator))
        cfg = self.cfg
        init = Init(generator, dtype, dev, place)
        params: Dict[str, Any] = {
            "embed": init.normal((cfg.vocab, cfg.d_model))}
        if not cfg.tie_embeddings:
            params["unembed"] = init.normal((cfg.d_model, cfg.vocab))
        params["final_norm"] = init_norm(cfg, init)
        params["units"] = tuple(
            _init_layer(cfg, kind, init, lead=(self.repeats,))
            for kind in self.unit)
        if self.tail:
            params["tail"] = tuple(_init_layer(cfg, kind, init)
                                   for kind in self.tail)
        if cfg.family == "hybrid":
            params["shared_attn"] = {"attn": init_attention(cfg, init),
                                     "mlp": init_mlp(cfg, init)}
        return params

    def param_shapes(self, dtype: torch.dtype = torch.float32):
        """The parameter tree on the ``meta`` device: shapes and dtypes
        only, nothing allocated."""
        return self._init(None, dtype, torch.device("meta"))

    def param_specs(self) -> Dict[str, Any]:
        """The parameter tree's logical axes, the reference's
        ``init(key)[1]``: the same keys, a tuple of axis names or ``None``
        a leaf, ``"stack"`` first on the leaves stacked over repeats."""
        cfg = self.cfg
        specs: Dict[str, Any] = {"embed": ("vocab", "embed_fsdp")}
        if not cfg.tie_embeddings:
            specs["unembed"] = ("embed_fsdp", "vocab")
        specs["final_norm"] = norm_specs(cfg)
        specs["units"] = tuple(stack_specs(_layer_specs(cfg, kind))
                               for kind in self.unit)
        if self.tail:
            specs["tail"] = tuple(_layer_specs(cfg, kind)
                                  for kind in self.tail)
        if cfg.family == "hybrid":
            specs["shared_attn"] = {"attn": attention_specs(cfg),
                                    "mlp": mlp_specs(cfg)}
        return specs

    # -- forward (train / prefill) -------------------------------------------

    def _unit(self, params, r: int, x, positions, mrope_positions=None):
        """Repeat ``r`` of the unit, then zamba2's shared block ->
        (x, the repeat's aux)."""
        cfg = self.cfg
        aux = _zero_aux(x)
        for i, kind in enumerate(self.unit):
            x, a = _apply_layer(cfg, kind, _index(params["units"][i], r), x,
                                positions=positions,
                                mrope_positions=mrope_positions)
            aux = aux + a
        shared = params.get("shared_attn")
        if shared is not None:
            x = apply_attention(cfg, shared["attn"], x, positions=positions)
            x = apply_mlp(cfg, shared["mlp"], x)
        return x, aux

    def _backbone(self, params, x, positions, mrope_positions=None,
                  remat: bool = False):
        """-> (x, aux summed over every layer).  ``remat`` keeps only each
        repeat's input for the backward, which runs the repeat's forward
        again (``jax.checkpoint(unit_body)``).  The tail takes plain RoPE,
        as in the reference."""
        cfg = self.cfg
        aux = _zero_aux(x)
        for r in range(self.repeats):
            if remat:
                x, a = checkpoint(self._unit, params, r, x, positions,
                                  mrope_positions, use_reentrant=False)
            else:
                x, a = self._unit(params, r, x, positions, mrope_positions)
            aux = aux + a
        for i, kind in enumerate(self.tail):
            x, a = _apply_layer(cfg, kind, params["tail"][i], x,
                                positions=positions)
            aux = aux + a
        return x, aux

    def _embed(self, params, tokens, vision_embeds=None):
        # the rows by token id (the reference's ``embed[tokens]``); on a
        # DTensor each rank looks up its vocab block's ids for its batch
        # block, and the constraint adds the blocks (one all-reduce;
        # scaled first, the partial rows went through a reduce-scatter and
        # an all-gather)
        ids = shard(tokens.long(), ("batch", None))
        x = shard(F.embedding(ids, shard(params["embed"], ("vocab", None))),
                  ("batch", None, None)) * 1.0
        if vision_embeds is not None:
            x = torch.cat([vision_embeds.to(x.dtype), x], dim=1)
        return shard(x, ("batch", None, None))

    def logits(self, params, x):
        """Logits in float32, over "vocab" on a placed model (as the
        reference's partitioner leaves them)."""
        cfg = self.cfg
        h = norm_apply(cfg, params["final_norm"], x)
        w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
        w = shard(w, (None, "vocab"))
        return shard(h @ w.to(h.dtype), ("batch", None, "vocab")).float()

    def train_loss(self, params, batch: Dict[str, torch.Tensor], *,
                   remat: bool = True) -> torch.Tensor:
        """batch: dict(tokens [B, S], and for a VLM ``vision_embeds``
        [B, V, d] and ``mrope_positions`` [3, B, V + S]).  The mean
        next-token cross-entropy over the text positions' ``logits[:, :-1]``
        in float32, plus ``0.01 * aux``."""
        tokens = batch["tokens"]
        vis = batch.get("vision_embeds")
        x = self._embed(params, tokens, vis)
        b, s, _ = x.shape
        positions = default_positions(b, s, device=x.device)
        x, aux = self._backbone(params, x, positions,
                                batch.get("mrope_positions"), remat=remat)
        logits = self.logits(params, x)
        if vis is not None:
            logits = logits[:, vis.shape[1]:]
        lp = log_softmax(logits[:, :-1])
        # each label's log-probability (take_along_axis in the reference)
        # as a sum over the vocab of lp where the vocab id is the label:
        # exact, and on a DTensor each rank sums its vocab block and one
        # all-reduce of [B, S-1] adds them; the gradient lands in the
        # label's block without a scatter over the whole vocab
        vocab = shard(replicate_like(torch.arange(lp.shape[-1],
                                                  device=lp.device), lp),
                      ("vocab",))
        hit = vocab == tokens[:, 1:, None].long()
        nll = -shard((lp * hit).sum(-1), ("batch", None))
        return shard(nll.mean() + 0.01 * aux, ())

    def prefill(self, params, tokens: torch.Tensor, vision_embeds=None,
                mrope_positions=None) -> torch.Tensor:
        """Full-sequence forward of ``tokens`` [B, S] (after
        ``vision_embeds``, if given); returns the last-position logits
        [B, vocab] in float32."""
        x = self._embed(params, tokens, vision_embeds)
        b, s, _ = x.shape
        positions = default_positions(b, s, device=x.device)
        x, _ = self._backbone(params, x, positions, mrope_positions)
        return self.logits(params, x[:, -1:])[:, 0]

    # -- serving -------------------------------------------------------------

    def cache_specs(self, b: int, s: int, dtype: torch.dtype = torch.bfloat16):
        """The cache tree as ``(shape, dtype)`` leaves: per unit position
        stacked over ``repeats``, the tail, and zamba2's shared-block
        caches (stacked over ``repeats``)."""
        def stacked(spec):
            if isinstance(spec, dict):
                return {k: stacked(v) for k, v in spec.items()}
            shape, dt = spec
            return ((self.repeats,) + tuple(shape), dt)

        out: Dict[str, Any] = {"units": tuple(
            stacked(_layer_cache_spec(self.cfg, kind, b, s, dtype))
            for kind in self.unit)}
        if self.tail:
            out["tail"] = tuple(_layer_cache_spec(self.cfg, k, b, s, dtype)
                                for k in self.tail)
        if self.cfg.family == "hybrid":
            out["shared"] = stacked(attn_cache_spec(self.cfg, b, s, None,
                                                    dtype))
        return out

    def init_cache(self, b: int, s: int, dtype: torch.dtype = torch.bfloat16,
                   device: DeviceLike = None):
        dev = resolve_device(device)
        specs = self.cache_specs(b, s, dtype)
        out = {"units": tuple(_zeros(u, (), dev) for u in specs["units"])}
        if "tail" in specs:
            out["tail"] = tuple(_zeros(t, (), dev) for t in specs["tail"])
        if "shared" in specs:
            out["shared"] = _zeros(specs["shared"], (), dev)
        return out

    def decode_step(self, params, caches, tokens: torch.Tensor):
        """tokens: [B, 1] -> (logits [B, vocab] float32, new caches).

        Attention caches are written in place (see
        :mod:`repro_torch.models.blocks`); the returned tree holds them
        with advanced lengths and the new Mamba2 and RWKV6 states."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        shared = params.get("shared_attn")
        unit_given: List[List[Any]] = [[] for _ in self.unit]
        unit_new: List[List[Any]] = [[] for _ in self.unit]
        shared_given, shared_new = [], []
        for r in range(self.repeats):
            for i, kind in enumerate(self.unit):
                c = _index(caches["units"][i], r)
                x, nc = _apply_layer_decode(
                    cfg, kind, _index(params["units"][i], r), x, c)
                unit_given[i].append(c)
                unit_new[i].append(nc)
            if shared is not None:
                c = _index(caches["shared"], r)
                x, nc = apply_attention_decode(cfg, shared["attn"], x, c)
                x = apply_mlp(cfg, shared["mlp"], x)
                shared_given.append(c)
                shared_new.append(nc)
        new: Dict[str, Any] = {"units": tuple(
            _restack(old, g, u) for old, g, u in
            zip(caches["units"], unit_given, unit_new))}
        if self.tail:
            tails = []
            for i, kind in enumerate(self.tail):
                x, nc = _apply_layer_decode(cfg, kind, params["tail"][i], x,
                                            caches["tail"][i])
                tails.append(nc)
            new["tail"] = tuple(tails)
        if shared is not None:
            new["shared"] = _restack(caches["shared"], shared_given,
                                     shared_new)
        return self.logits(params, x)[:, 0], new
