"""Whisper-style encoder-decoder backbone (the audio frontend stubbed).

Port of ``repro.models.whisper``.  The audio frontend (two convolutions
and a GELU over log-mel) is a stub, as in the reference: the encoder takes
precomputed frame embeddings [B, enc_seq, d_model].  The backbone: pre-LN
LayerNorm, GELU MLPs, a non-causal encoder, and a decoder of causal
self-attention, cross-attention to the encoder's output and an MLP.  The
reference's ``lax.scan`` over the stacked layers becomes a Python loop;
each layer's parameters are a slice of the stacked tree, whose layout is
the reference's (so converted weights compare leaf for leaf).

Entry points::

    init(generator, dtype, device)          -> params
    param_specs()                           -> the reference's logical axes
    encode(params, frames)                  -> encoder output [B, Se, d]
    train_loss(params, batch)               -> next-token cross-entropy
    prefill(params, frames, tokens)         -> last-position logits [B, V]
    decode_step(params, caches, tokens)     -> (logits [B, V], caches)

On a CUDA device every full-sequence attention launches the
flash-attention kernel: the encoder's layers (non-causal), the decoder's
self-attention (causal) and its cross-attention (non-causal, Sq != Sk),
in the prefill and, for the cross-attention, in every decode step.

The reference's decode step rotates the decoder's self-attention queries
and keys by RoPE (``apply_attention_decode`` always does), while its
prefill and ``train_loss`` pass ``positions=None`` and rotate nothing.
So a prefill and the teacher-forced decode of the same tokens differ.
The port keeps that fault of the reference as it is (ROADMAP, Queue 3).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.parallel.sharding import shard
from .blocks import (
    _qkv, apply_attention, apply_attention_decode, apply_mlp,
    attention_specs, attn_cache_spec, init_attention, init_mlp, init_norm,
    mlp_specs, norm_apply, norm_specs,
)
from .common import Init
from .config import ModelConfig
from .lm import _index, _restack, _zeros, stack_specs


class EncDec:
    """Functional model object: init / encode / train_loss / prefill /
    decode_step."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    # -- init ----------------------------------------------------------------

    def init(self, generator: Union[None, int, torch.Generator] = None,
             dtype: torch.dtype = torch.float32,
             device: DeviceLike = None, *,
             place: Optional[Callable[[torch.Tensor], Any]] = None
             ) -> Dict[str, Any]:
        """Random parameters from ``generator`` (a ``torch.Generator`` on
        ``device`` or an int seed, ``None`` = 0), as :meth:`LM.init`."""
        return self._init(generator, dtype, resolve_device(device), place)

    def _init(self, generator, dtype, dev: torch.device, place=None):
        if dev.type != "meta" and not isinstance(generator, torch.Generator):
            generator = torch.Generator(device=dev).manual_seed(
                0 if generator is None else int(generator))
        cfg = self.cfg
        init = Init(generator, dtype, dev, place)
        n_enc, n_dec = (cfg.n_enc_layers,), (cfg.n_layers,)
        enc = {"attn": init_attention(cfg, init, n_enc),
               "mlp": init_mlp(cfg, init, lead=n_enc)}
        dec = {"self_attn": init_attention(cfg, init, n_dec),
               "cross_attn": init_attention(cfg, init, n_dec),
               "mlp": init_mlp(cfg, init, lead=n_dec)}
        return {
            "embed": init.normal((cfg.vocab, cfg.d_model)),
            "pos_dec": init.normal((cfg.max_seq, cfg.d_model)),
            "pos_enc": init.normal((cfg.enc_seq, cfg.d_model)),
            "enc": enc, "dec": dec,
            "enc_norm": init_norm(cfg, init),
            "final_norm": init_norm(cfg, init),
        }

    def param_shapes(self, dtype: torch.dtype = torch.float32):
        """The parameter tree on the ``meta`` device."""
        return self._init(None, dtype, torch.device("meta"))

    def param_specs(self) -> Dict[str, Any]:
        """The parameter tree's logical axes, the reference's
        ``init(key)[1]`` (see :meth:`LM.param_specs`)."""
        cfg = self.cfg
        enc = {"attn": attention_specs(cfg), "mlp": mlp_specs(cfg)}
        dec = {"self_attn": attention_specs(cfg),
               "cross_attn": attention_specs(cfg), "mlp": mlp_specs(cfg)}
        return {"embed": ("vocab", "embed_fsdp"), "pos_dec": (None, None),
                "pos_enc": (None, None), "enc": stack_specs(enc),
                "dec": stack_specs(dec), "enc_norm": norm_specs(cfg),
                "final_norm": norm_specs(cfg)}

    # -- encoder -------------------------------------------------------------

    def _enc_layer(self, layer, h):
        h = apply_attention(self.cfg, layer["attn"], h, positions=None,
                            causal=False)
        return apply_mlp(self.cfg, layer["mlp"], h)

    def encode(self, params, frames: torch.Tensor,
               remat: bool = False) -> torch.Tensor:
        """frames [B, Se, d] -> the normed encoder output [B, Se, d]."""
        cfg = self.cfg
        x = frames + params["pos_enc"][None, :frames.shape[1]]
        for i in range(cfg.n_enc_layers):
            layer = _index(params["enc"], i)
            if remat:
                x = checkpoint(self._enc_layer, layer, x,
                               use_reentrant=False)
            else:
                x = self._enc_layer(layer, x)
        return norm_apply(cfg, params["enc_norm"], x)

    def _enc_kv(self, cfg: ModelConfig, layer, enc_out: torch.Tensor):
        """The cross-attention's keys and values of the encoder output,
        [B, Hkv, Se, hd] each (normed by the cross block's own norm)."""
        _, k, v = _qkv(cfg, layer["cross_attn"],
                       norm_apply(cfg, layer["cross_attn"]["norm"], enc_out))
        return k, v

    # -- decoder (full sequence) ---------------------------------------------

    def _dec_layer(self, layer, h, enc_out):
        cfg = self.cfg
        # the reference passes positions=None: no RoPE in the prefill
        h = apply_attention(cfg, layer["self_attn"], h, positions=None,
                            causal=True)
        kv = self._enc_kv(cfg, layer, enc_out)
        h = apply_attention(cfg, layer["cross_attn"], h, positions=None,
                            causal=False, kv=kv)
        return apply_mlp(cfg, layer["mlp"], h)

    def _embed(self, params, tokens, pos):
        """The rows of ``tokens`` [B, S] (the reference's
        ``embed[tokens]``) plus the positions' rows ``pos`` [S, d], laid
        out by batch (the reference's constraint).  On a DTensor the
        lookup is the LM's (``LM._embed``): each rank reads its vocab
        block's ids for its batch block, and a constraint adds the blocks
        (one all-reduce); an index into the embedding leaves a layout,
        strided over "data", that the first projection cannot take.  The
        second constraint lays the gradient of the sum out whole over
        "model" before it reaches the lookup's partial rows."""
        ids = shard(tokens.long(), ("batch", None))
        x = F.embedding(ids, shard(params["embed"], ("vocab", None)))
        x = shard(x, ("batch", None, None)) + pos[None]
        return shard(x, ("batch", None, None))

    def _decoder(self, params, tokens, enc_out, remat: bool):
        s = tokens.shape[1]
        x = self._embed(params, tokens, params["pos_dec"][:s])
        for i in range(self.cfg.n_layers):
            layer = _index(params["dec"], i)
            if remat:
                x = checkpoint(self._dec_layer, layer, x, enc_out,
                               use_reentrant=False)
            else:
                x = self._dec_layer(layer, x, enc_out)
        return x

    def _logits(self, params, x):
        """The tied unembedding in float32.  On a DTensor the embedding is
        laid out for the product, over "vocab", as ``LM.logits`` lays it
        out: its gradient then comes back in the parameter's own layout,
        where the lookup's is added to it."""
        h = norm_apply(self.cfg, params["final_norm"], x)
        w = shard(params["embed"].T, (None, "vocab"))
        return (h @ w.to(h.dtype)).float()

    def train_loss(self, params, batch: Dict[str, torch.Tensor], *,
                   remat: bool = True) -> torch.Tensor:
        """batch: dict(frames [B, Se, d], tokens [B, S]).  The mean
        next-token cross-entropy over ``logits[:, :-1]``, in float32.
        ``remat`` recomputes each layer in the backward, as the
        reference's ``jax.checkpoint`` does."""
        frames, tokens = batch["frames"], batch["tokens"]
        enc_out = self.encode(params, frames, remat=remat)
        x = self._decoder(params, tokens, enc_out, remat)
        logits = self._logits(params, x)
        lp = torch.log_softmax(logits[:, :-1], dim=-1)
        nll = -lp.gather(-1, tokens[:, 1:, None].long())[..., 0]
        return nll.mean()

    def prefill(self, params, frames: torch.Tensor,
                tokens: torch.Tensor) -> torch.Tensor:
        """Encode, then a teacher-forced decoder pass over ``tokens``
        [B, S]; returns the last-position logits [B, vocab] in float32."""
        enc_out = self.encode(params, frames)
        x = self._decoder(params, tokens, enc_out, remat=False)
        return self._logits(params, x[:, -1:])[:, 0]

    # -- serving -------------------------------------------------------------

    def cache_specs(self, b: int, s: int, dtype: torch.dtype = torch.bfloat16):
        """``self``: the decoder's attention caches stacked over layers;
        ``cross``: the encoder's keys and values a layer, [L, B, Hkv, Se,
        hd].  Leaves are ``(shape, dtype)``."""
        cfg = self.cfg
        stacked = {k: ((cfg.n_layers,) + tuple(shape), dt) for k, (shape, dt)
                   in attn_cache_spec(cfg, b, s, None, dtype).items()}
        kv = ((cfg.n_layers, b, cfg.n_kv_heads, cfg.enc_seq, cfg.hd), dtype)
        return {"self": stacked, "cross": {"k": kv, "v": kv}}

    def init_cache(self, b: int, s: int, dtype: torch.dtype = torch.bfloat16,
                   device: DeviceLike = None):
        """Zero caches.  The cross caches stay zero until the caller fills
        them (from :meth:`_enc_kv`); the serving engine leaves them zero,
        as the reference's does."""
        return _zeros(self.cache_specs(b, s, dtype), (),
                      resolve_device(device))

    def decode_step(self, params, caches, tokens: torch.Tensor):
        """tokens [B, 1] -> (logits [B, vocab] float32, new caches).

        The self-attention caches are written in place; ``cross`` is
        returned as given.  Each layer's cross-attention is one
        full-sequence attention (Sq = 1 against Se keys, non-causal).
        """
        cfg = self.cfg
        length = caches["self"]["length"][0]
        # the row at the cache length by a one-element index: a static
        # shape, which fake tensors (the dry run) can give
        x = self._embed(params, tokens, params["pos_dec"].index_select(
            0, length.long().reshape(1)))
        given: List[Any] = []
        new_self: List[Any] = []
        for i in range(cfg.n_layers):
            layer = _index(params["dec"], i)
            # apply_attention_decode rotates q and k by RoPE at ``length``:
            # the reference's decode does, its prefill does not (module
            # docstring)
            given.append(_index(caches["self"], i))
            x, nc = apply_attention_decode(cfg, layer["self_attn"], x,
                                           given[-1])
            new_self.append(nc)
            x = apply_attention(cfg, layer["cross_attn"], x, positions=None,
                                causal=False,
                                kv=(caches["cross"]["k"][i],
                                    caches["cross"]["v"][i]))
            x = apply_mlp(cfg, layer["mlp"], x)
        logits = self._logits(params, x)[:, 0]
        return logits, {"self": _restack(caches["self"], given, new_self),
                        "cross": caches["cross"]}
