"""End-to-end driver of the PyTorch/CUDA port: train a ~100M-param LM on
the card with the Paxos control plane.

The port's counterpart of ``examples/train_fault_tolerant.py``, with the
same model sizes, data, optimiser, checkpoint cadence and faults:

  * data shards are FAA-leased through the replicated register
    (exactly-once across restarts),
  * checkpoints are CAS-committed (the filesystem is never the source of
    truth),
  * a *mid-run crash + restart* of the trainer: the second run resumes
    from the committed step and continues the lease sequence — no batch
    trained twice, none skipped, loss keeps descending,
  * a registry replica is crashed during training: zero stall.

The registry's replicas run the batched serve path (``BatchedMachine``:
the ``paxos_apply`` and ``paxos_propose`` kernels on a CUDA device) and
the model's forward runs the ``flash_attention`` kernel, both on the same
device.  Parameters are drawn from a seeded ``torch.Generator``
(``TrainConfig.seed``) on the device.

    PYTHONPATH=src python examples/torch_train_fault_tolerant.py --full
    PYTHONPATH=src python examples/torch_train_fault_tolerant.py \\
        --device cpu --ckpt-dir build/ckpt
"""

import argparse
import functools
import pathlib
import shutil
import sys

from repro_torch.coord.registry import PaxosRegistry
from repro_torch.data.pipeline import DataConfig
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import build_model
from repro_torch.optim import adamw
from repro_torch.serve.paxos import BatchedMachine
from repro_torch.train.loop import TrainConfig, train

CKPT = str(pathlib.Path(__file__).resolve().parents[1] / "build"
           / "torch_ckpt_example")
RUN = "demo"


def make_model(full: bool):
    if full:
        # ~100M params: 8 layers, d=512, 16k vocab (a few hundred steps;
        # sized for a real accelerator — slow on 1 CPU core)
        cfg = ModelConfig(name="demo-100m", family="dense", n_layers=8,
                          d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048,
                          vocab=16384)
    else:
        cfg = ModelConfig(name="demo-16m", family="dense", n_layers=4,
                          d_model=256, n_heads=4, n_kv_heads=4, d_ff=1024,
                          vocab=8192)
    print(f"model: {cfg.n_params() / 1e6:.1f}M params")
    return build_model(cfg), cfg


def settings(full: bool):
    """``(half, total, every)``: the resume step, the last step and the
    checkpoint and log cadence."""
    half = 150 if full else 20
    return half, 2 * half, 50 if full else 10


def run(full: bool, ckpt_dir: str, device) -> dict:
    """Both training runs, the registry crash and the backup grant on
    ``device``; returns the two runs' outputs, the registry, the
    committed checkpoints and the losses."""
    half, total, every = settings(full)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    registry = PaxosRegistry(n_machines=5, all_aboard=True,
                             machine_cls=functools.partial(BatchedMachine,
                                                           device=device))
    model, mcfg = make_model(full)
    data = DataConfig(vocab=mcfg.vocab, seq_len=128, batch=8)
    opt = adamw.AdamWConfig(lr=1e-3, total_steps=total, warmup_steps=10)
    committed = []

    def on_ckpt(step, won):
        committed.append((step, won))
        print(f"   ckpt step {step} committed={won}")

    # ---- phase 1: train to the midpoint, checkpointing ---------------------
    t1 = TrainConfig(run=RUN, steps=half, ckpt_every=every,
                     ckpt_dir=ckpt_dir, log_every=every)
    out1 = train(model, data, t1, opt, registry,
                 hooks={"on_log": lambda m: print("  ", m),
                        "on_ckpt": on_ckpt}, device=device)
    print(f"phase 1 done (wall {out1['wall_s']:.1f}s); "
          f"committed step = {registry.latest_checkpoint(RUN)}")

    # ---- crash a registry replica: control plane must not stall ----------
    registry.crash(4)
    print("crashed registry replica 4 (4/5 alive, majority intact)")

    # ---- phase 2: simulate trainer crash + restart ------------------------
    # a NEW loop instance resumes from the committed checkpoint; shard
    # leases continue from the registry cursor (exactly-once data)
    t2 = TrainConfig(run=RUN, steps=total, ckpt_every=every,
                     ckpt_dir=ckpt_dir, log_every=every)
    out2 = train(model, data, t2, opt, registry,
                 hooks={"on_log": lambda m: print("  ", m),
                        "on_ckpt": lambda s, won: committed.append((s, won))},
                 device=device)
    assert out2["start_step"] == half, out2["start_step"]
    print(f"resumed from step {out2['start_step']}, "
          f"final committed = {registry.latest_checkpoint(RUN)}")

    losses = [h["loss"] for h in out1["history"] + out2["history"]]
    print("loss trajectory:", " ".join(f"{l:.3f}" for l in losses))
    assert losses[-1] < losses[0], "loss must descend across the restart"

    # straggler-mitigation grant: only one of two "racing" executors wins
    a = registry.claim_backup(RUN, step=total + 1, node=0)
    b = registry.claim_backup(RUN, step=total + 1, node=1)
    assert a and not b
    print("straggler backup grant: node0 won, node1 discarded — "
          "exactly-once update")
    return {"out1": out1, "out2": out2, "registry": registry,
            "committed": committed, "losses": losses, "backup": (a, b),
            "model": model, "data": data, "opt": opt}


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="~100M params, 300 steps (accelerator-sized)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--ckpt-dir", default=CKPT,
                    help="checkpoint directory, emptied first "
                         "(default: %(default)s)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device if device is None else device)
    run(args.full, args.ckpt_dir, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
