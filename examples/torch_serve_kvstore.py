"""Serve a small LM on the card with batched decode + Paxos-routed
sessions (the PyTorch/CUDA port).

The port's counterpart of ``examples/serve_kvstore.py``.  The serving
control plane is the paper's register, served by ``BatchedMachine`` on
the same device as the model: session->replica routes are CAS'd once and
ABD-read per request; a router replica crash does not interrupt routing
(no election).  Live reconfiguration (``reconfig=True``) grows the fleet
by one replica and retires the crashed one, both by CAS on the config
register.

The engine's ``generate`` runs the prompts through decode steps, which
read the KV cache without the attention kernel, so the example then
prefills the same prompts in one pass (the ``flash_attention`` kernel on
a CUDA device) and holds its last-position logits to the decode path's.

Parameters are drawn from a seeded ``torch.Generator`` on the device.

    PYTHONPATH=src python examples/torch_serve_kvstore.py             # card
    PYTHONPATH=src python examples/torch_serve_kvstore.py --device cpu
"""

import argparse
import functools
import sys

import numpy as np
import torch

from repro_torch.coord.registry import PaxosRegistry
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import DecodeEngine, ServeConfig
from repro_torch.serve.paxos import BatchedMachine

CFG = ModelConfig(name="demo-serve", family="dense", n_layers=4,
                  d_model=256, n_heads=4, n_kv_heads=2, d_ff=1024,
                  vocab=4096, window=None)
SEED = 0
MAX_SEQ = 64
# the prefill's last-position logits against the decode path's: max
# absolute error over max |logit|
PREFILL_TOL = 1e-3


def init_params(model, device):
    gen = torch.Generator(device=device).manual_seed(SEED)
    return model.init(gen, device=device)


def padded(prompts, device) -> torch.Tensor:
    """The prompts left-padded with token 0, as ``generate`` pads them."""
    toks = np.zeros((len(prompts), max(len(p) for p in prompts)), np.int32)
    for i, p in enumerate(prompts):
        toks[i, toks.shape[1] - len(p):] = p
    return torch.from_numpy(toks).to(device)


def prefill_error(model, params, prompts, device) -> float:
    """One prefill of the padded prompts against the teacher-forced decode
    steps over the same tokens: max logit error over max |logit|."""
    toks = padded(prompts, device)
    with torch.no_grad():
        got = model.prefill(params, toks)
        caches = model.init_cache(toks.shape[0], MAX_SEQ,
                                  dtype=torch.float32, device=device)
        for t in range(toks.shape[1]):
            want, caches = model.decode_step(params, caches,
                                             toks[:, t:t + 1])
    return float((got - want).abs().max() / want.abs().max())


def serve(model, params, device) -> dict:
    """The example's service on ``device``; returns the routes, the
    generated tokens, the registry and the prefill's error."""
    registry = PaxosRegistry(n_machines=5, all_aboard=True, reconfig=True,
                             machine_cls=functools.partial(BatchedMachine,
                                                           device=device))
    engines = [DecodeEngine(model, params, ServeConfig(max_seq=MAX_SEQ),
                            registry, replica_id=r, device=device)
               for r in range(2)]

    # sticky routing through the replicated register
    sessions = [101, 102, 103, 104]
    routes = {s: engines[0].route(s) if s % 2 else engines[1].route(s)
              for s in sessions}
    print("routes:", routes)
    # routes are sticky: every replica resolves the same assignment
    for s in sessions:
        assert engines[0].route(s) == routes[s] == engines[1].route(s)

    # crash a registry replica mid-service: routing keeps working
    registry.crash(2)
    assert engines[0].route(101) == routes[101]
    print("routing survives registry replica crash")

    # live reconfiguration under load: grow the fleet by one replica (the
    # joiner snapshots a peer and replays the committed tail before it
    # votes), then retire the crashed replica from the membership — both
    # are CASes on the config register through the normal consensus path
    new_mid = registry.add_replica()
    view = registry.cluster.active_view
    print(f"replica {new_mid} joined live: view epoch {view.epoch}, "
          f"members {view.members}")
    assert engines[0].route(101) == routes[101]   # routing uninterrupted
    registry.remove_replica(2)
    view = registry.cluster.active_view
    print(f"crashed replica retired: view epoch {view.epoch}, "
          f"members {view.members}")
    assert engines[1].route(102) == routes[102]

    # batched greedy generation
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(1, 4096, rng.integers(3, 9)))
               for _ in sessions]
    out = engines[0].generate(prompts, steps=12)
    print("generated token matrix:\n", out)
    assert out.shape == (4, 12) and (out >= 0).all()

    # the same prompts through the full-sequence prefill
    err = prefill_error(model, params, prompts, device)
    print(f"prefill of the prompts agrees with the decode path: max logit "
          f"error {err:.3g} of max |logit| (limit {PREFILL_TOL:g})")
    assert err <= PREFILL_TOL, err
    return {"routes": routes, "tokens": out, "registry": registry,
            "prefill_err": err}


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device if device is None else device)
    model = build_model(CFG)
    serve(model, init_params(model, dev), dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
