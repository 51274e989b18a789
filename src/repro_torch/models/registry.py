"""Model registry and per-(arch, shape) input specs.

Port of ``repro.models.registry``.  ``input_specs`` gives every model
input of a cell as a ``(shape, dtype)`` leaf, as ``LM.cache_specs`` does
(the reference gives ``jax.ShapeDtypeStruct`` stand-ins for its dry-run);
the tests and ``chip_smoke.py`` build their VLM and encoder-decoder inputs
from it.
"""

from __future__ import annotations

from typing import Any, Dict, Union

import torch

from repro_torch.configs.shapes import Shape
from .config import ModelConfig
from .lm import LM
from .whisper import EncDec

VISION_TOKENS = 256          # VLM stub: patch embeddings prepended


def build_model(cfg: ModelConfig) -> Union[LM, EncDec]:
    if cfg.family == "encdec":
        return EncDec(cfg)
    return LM(cfg)


def input_specs(cfg: ModelConfig, shape: Shape,
                dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """``(shape, dtype)`` of every model input of this cell: ``tokens``,
    and ``frames`` (encoder-decoder prefill and train) or
    ``vision_embeds`` [B, VISION_TOKENS, d] and ``mrope_positions``
    [3, B, S + VISION_TOKENS] (VLM prefill and train).  A decode cell
    takes one token a sequence."""
    b, s = shape.global_batch, shape.seq_len
    tok = ((b, s), torch.int32)
    if shape.kind == "decode":
        return {"tokens": ((b, 1), torch.int32)}
    if cfg.family == "encdec":
        return {"frames": ((b, cfg.enc_seq, cfg.d_model), dtype),
                "tokens": tok}
    out = {"tokens": tok}
    if cfg.family == "vlm":
        out["vision_embeds"] = ((b, VISION_TOKENS, cfg.d_model), dtype)
        out["mrope_positions"] = ((3, b, s + VISION_TOKENS), torch.int32)
    return out
