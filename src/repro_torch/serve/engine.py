"""Batched decode engine with a Paxos-routed session table.

Port of ``repro.serve.engine``.  The serving router state (session ->
replica) lives in the replicated register: a session's route is
claimed-or-discovered with a single CAS-with-fetch RMW (the CAS returns the
pre-state, §4) and is write-once, so repeat lookups hit a local cache;
routing survives any minority of router failures with zero election
downtime.

Generation keeps the reference's semantics exactly: prompts are
left-padded with token 0, teacher-forced through ``decode_step`` one
position at a time (float32 caches, one length for the whole batch), then
decoded greedily (first maximal logit), on plain parameters or on
parameters placed on a (data, model) mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.coord.registry import PaxosRegistry
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch import steps as launch_steps
from repro_torch.parallel.sharding import replicate_like, shard


@dataclasses.dataclass
class ServeConfig:
    max_seq: int = 256
    batch: int = 4
    temperature: float = 0.0     # 0 = greedy


class DecodeEngine:
    def __init__(self, model, params, cfg: ServeConfig,
                 registry: Optional[PaxosRegistry] = None,
                 replica_id: int = 0, device: DeviceLike = None):
        """``device`` holds the caches and tokens (``None`` means
        ``"cuda"``); ``params`` must already live there."""
        self.model = model
        self.params = params
        self.cfg = cfg
        self.registry = registry
        self.replica_id = replica_id
        self.device = resolve_device(device)
        self._routes: Dict[int, int] = {}    # write-once decided routes

    def route(self, session: int) -> int:
        """Sticky session routing through the replicated register.

        First sight of a session costs ONE CAS-with-fetch round trip: a
        CAS RMW always returns the pre-state (§4), so claiming an unrouted
        session and discovering an existing route are the *same* consensus
        op.  Routes are write-once (the CAS only installs over 0), so the
        decided route is cached locally and repeat lookups are free.
        """
        if self.registry is None:
            return self.replica_id
        cached = self._routes.get(session)
        if cached is not None:
            return cached
        _won, prev = self.registry.cas(f"route/{session}", 0,
                                       self.replica_id + 1)
        decided = self.replica_id if prev == 0 else prev - 1
        self._routes[session] = decided
        return decided

    def generate(self, prompts: List[List[int]], steps: int,
                 prefill_extra: Optional[Dict] = None) -> np.ndarray:
        """Greedy batched generation -> int32 tokens [B, steps].

        On parameters placed on a mesh (DTensors, ``launch/steps.py``
        ``place_cell``) the caches and each step's tokens are laid out as
        the decode cell lays them out (``steps.decode_inputs``), and the
        greedy pick reads the vocab-sharded logits where they lie
        (:func:`greedy`); every rank gets the whole [B, steps]."""
        b = len(prompts)
        plen = max(len(p) for p in prompts)
        toks = np.zeros((b, plen), np.int32)
        for i, p in enumerate(prompts):
            toks[i, plen - len(p):] = p          # left-pad
        toks_dev = torch.from_numpy(toks).to(self.device)
        caches, feed = launch_steps.decode_inputs(
            self.model, self.params, b, self.cfg.max_seq, self.device)
        # teacher-forced prefill through decode steps (simple + exact)
        out = np.zeros((b, steps), np.int32)
        for t in range(plen):
            logits, caches = self.model.decode_step(
                self.params, caches, feed(toks_dev[:, t:t + 1]))
        last = greedy(logits)[:, None].to(torch.int32)
        for t in range(steps):
            out[:, t] = last[:, 0].cpu().numpy()
            logits, caches = self.model.decode_step(self.params, caches,
                                                    feed(last))
            last = greedy(logits)[:, None].to(torch.int32)
        return out


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """The first maximal logit's index a row of ``logits`` [B, vocab], as
    ``argmax``.  On a DTensor over "vocab" each rank reads its block: the
    max and the least index that holds it are reduced over the blocks (an
    all-reduce of [B, 1] each), and the [B] result comes back whole on
    every rank."""
    if not isinstance(logits, DTensor):
        return logits.argmax(-1)
    top = logits.amax(-1, keepdim=True)
    vocab = shard(replicate_like(torch.arange(logits.shape[-1],
                                              device=logits.device), logits),
                  ("vocab",))
    first = torch.where(logits == top, vocab, logits.shape[-1]).amin(-1)
    return first.full_tensor()
