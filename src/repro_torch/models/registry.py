"""Model registry.

Port of ``repro.models.registry``.  The encoder-decoder family (whisper)
is not ported yet: :class:`LM` raises for it.  ``input_specs`` (the
reference's dry-run shape stand-ins) has no counterpart here.
"""

from __future__ import annotations

from .config import ModelConfig
from .lm import LM


def build_model(cfg: ModelConfig) -> LM:
    return LM(cfg)
