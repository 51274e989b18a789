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
decoded greedily (first maximal logit).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.coord.registry import PaxosRegistry
from repro_torch.device import DeviceLike, resolve_device


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
        """Greedy batched generation -> int32 tokens [B, steps]."""
        b = len(prompts)
        plen = max(len(p) for p in prompts)
        toks = np.zeros((b, plen), np.int32)
        for i, p in enumerate(prompts):
            toks[i, plen - len(p):] = p          # left-pad
        toks_dev = torch.from_numpy(toks).to(self.device)
        caches = self.model.init_cache(b, self.cfg.max_seq,
                                       dtype=torch.float32,
                                       device=self.device)
        # teacher-forced prefill through decode steps (simple + exact)
        out = np.zeros((b, steps), np.int32)
        for t in range(plen):
            logits, caches = self.model.decode_step(self.params, caches,
                                                    toks_dev[:, t:t + 1])
        last = logits.argmax(-1)[:, None].to(torch.int32)
        for t in range(steps):
            out[:, t] = last[:, 0].cpu().numpy()
            logits, caches = self.model.decode_step(self.params, caches,
                                                    last)
            last = logits.argmax(-1)[:, None].to(torch.int32)
        return out
