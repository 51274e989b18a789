"""Deterministic synthetic data pipeline with Paxos-leased shards.

Port of ``repro.data.pipeline``.  Shards are claimed through the
coordination service's FAA cursor — each shard is handed out exactly once
across restarts and elastic scale events, so no batch is trained twice and
none is skipped (the lease, not the trainer, is the source of truth).
Token content is a deterministic function of (shard, position), drawn with
numpy's Philox exactly as the reference draws it, so both packages train
on the same integers.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.coord.registry import PaxosRegistry
from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass
class DataConfig:
    vocab: int = 1024
    seq_len: int = 128
    batch: int = 8
    batches_per_shard: int = 4
    seed: int = 1234


def synth_batch(cfg: DataConfig, shard: int, index: int) -> np.ndarray:
    """Deterministic int32 tokens [batch, seq_len] for (shard, index): a
    keyed PRNG stream.

    The stream is *learnable* (Zipf unigram + first-order repetition), so
    training loss measurably descends from the uniform floor log(vocab).
    """
    rng = np.random.Generator(np.random.Philox(
        key=cfg.seed, counter=[0, 0, shard, index]))
    zipf = rng.zipf(1.3, (cfg.batch, cfg.seq_len)).astype(np.int64)
    toks = (zipf - 1) % cfg.vocab
    # 50% of positions copy their predecessor (an easy bigram signal)
    rep = rng.random((cfg.batch, cfg.seq_len)) < 0.5
    for t in range(1, cfg.seq_len):
        toks[:, t] = np.where(rep[:, t], toks[:, t - 1], toks[:, t])
    return toks.astype(np.int32)


class ShardedStream:
    """Pulls shard leases from the registry, yields that shard's batches
    as int32 tensors on ``device`` (``None`` means ``"cuda"``)."""

    def __init__(self, cfg: DataConfig, registry: Optional[PaxosRegistry],
                 run: str = "run0", device: DeviceLike = None):
        self.cfg = cfg
        self.registry = registry
        self.run = run
        self.device = resolve_device(device)
        self._local_cursor = 0      # fallback without a registry

    def claim(self) -> int:
        if self.registry is None:
            s, self._local_cursor = self._local_cursor, self._local_cursor + 1
            return s
        return self.registry.claim_shard(self.run)

    def __iter__(self) -> Iterator[torch.Tensor]:
        while True:
            shard = self.claim()
            for i in range(self.cfg.batches_per_shard):
                yield torch.from_numpy(synth_batch(self.cfg, shard, i)).to(
                    self.device)
