"""Fault-tolerant training loop.

Port of ``repro.train.loop``.  Every piece of cross-node coordination goes
through the paper's replicated RMW register
(:class:`repro_torch.coord.registry.PaxosRegistry`):

* data shards are FAA-leased (exactly-once across restarts),
* checkpoints are CAS-committed (a torn or duplicate commit is
  impossible),
* membership is a CAS'd epoch word; on a change the ``on_membership`` hook
  runs (single-host: nothing to re-build),
* straggler backup steps are CAS grants (losers discard their update).

The loop is synchronous SGD.  With ``machine_cls=BatchedMachine`` the
registry's replicas run the ``paxos_apply`` and ``paxos_propose`` kernels,
and the model's forward the float kernels, on the same card.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, Optional

from repro_torch.checkpoint import store
from repro_torch.coord.registry import PaxosRegistry
from repro_torch.data.pipeline import DataConfig, ShardedStream
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.optim import adamw


@dataclasses.dataclass
class TrainConfig:
    run: str = "run0"
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    log_every: int = 10
    microbatches: int = 1
    seed: int = 0


def train(model, data_cfg: DataConfig, tcfg: TrainConfig,
          opt_cfg: Optional[adamw.AdamWConfig] = None,
          registry: Optional[PaxosRegistry] = None,
          hooks: Optional[Dict[str, Callable]] = None,
          device: DeviceLike = None) -> Dict[str, Any]:
    """Runs (or resumes) a training run on ``device`` (``None`` means
    ``"cuda"``); returns the final state and the logged history.

    Parameters are ``model.init(tcfg.seed)``, or the registry's committed
    checkpoint of ``(params, opt_state)`` when there is one.  Hooks:
    ``on_log(record)``, ``on_ckpt(step, won)``, ``on_membership(epoch)``.
    """
    dev = resolve_device(device)
    hooks = hooks or {}
    opt_cfg = opt_cfg or adamw.AdamWConfig(total_steps=tcfg.steps)
    params = model.init(tcfg.seed, device=dev)
    opt_state = adamw.init(opt_cfg, params)

    start_step = 0
    if registry is not None:
        committed = registry.latest_checkpoint(tcfg.run)
        if committed > 0:
            (params, opt_state), start_step = store.restore(
                tcfg.ckpt_dir, tcfg.run, (params, opt_state), registry)

    step_fn = make_train_step(model, opt_cfg,
                              microbatches=tcfg.microbatches)
    stream = iter(ShardedStream(data_cfg, registry, tcfg.run, device=dev))
    history = []
    t0 = time.time()
    membership_epoch = registry.membership(tcfg.run) if registry else 0

    for step in range(start_step + 1, tcfg.steps + 1):
        tokens = next(stream)
        params, opt_state, metrics = step_fn(params, opt_state,
                                             {"tokens": tokens})
        if step % tcfg.log_every == 0 or step == tcfg.steps:
            loss = float(metrics["loss"])
            history.append({"step": step, "loss": loss,
                            "grad_norm": float(metrics["grad_norm"])})
            if "on_log" in hooks:
                hooks["on_log"](history[-1])
        if registry is not None and step % tcfg.ckpt_every == 0:
            won = store.save(tcfg.ckpt_dir, tcfg.run, step,
                             (params, opt_state), registry)
            if "on_ckpt" in hooks:
                hooks["on_ckpt"](step, won)
        if registry is not None and "on_membership" in hooks:
            epoch = registry.membership(tcfg.run)
            if epoch != membership_epoch:
                membership_epoch = epoch
                hooks["on_membership"](epoch)

    return {"params": params, "opt_state": opt_state, "history": history,
            "wall_s": time.time() - t0, "start_step": start_step}
