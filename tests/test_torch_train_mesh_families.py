"""Every family's whole sharded train step: ``launch/steps.place_cell``
places the train cells of the rwkv6-7b, zamba2-7b, mixtral-8x7b (its
published shard_map TP MoE) and whisper-large-v3 smoke configs on a
(2, 2) (data, model) mesh of gloo ranks as DTensors, by ``build_cell``'s
shardings (FSDP over "data", heads, mlp, experts' ff and vocab over
"model", ZeRO-1 moments, the batch over "data"), and
``make_train_step``'s AdamW step runs on them unchanged, each rank on its
blocks, under ``parallel/peer_staged.PeerStaged`` as on the card (for
CPU tensors here: every collective through ``launch/collectives.py``'s
table, the functional ones through files each group maps).
``tests/test_torch_recurrent_mesh.py``, ``test_torch_moe_mesh.py`` and
``test_torch_encdec_mesh.py`` hold these cells' ``train_loss`` and
gradients; this file holds the steps.

The port's side runs on 4 spawned ranks (``tests/torch_ranks.py``, rank
body ``tests/torch_mesh_ranks.train_families_rank``), one group for the
four configs; no process group runs in the pytest worker.  The
reference's side runs beside them in one fresh subprocess, the configs
one after another (``tests/torch_train_mesh_ref.py``): its ``make_train_step`` jitted with
``param_shardings`` on its own 2 x 2 mesh of 4 XLA host devices, under
its mesh, so that mixtral takes its ``shard_map``.  mixtral's one process
routes block by block (``torch_mesh_ranks.blockwise``), as each data rank
routes its batch block.

Weights: the reference's ``init`` perturbed with numpy noise, carried
over by ``models/convert.params_from_reference``; tokens and whisper's
frames: numpy draws from a seed, one batch a step.

Three AdamW steps at ``tests/test_torch_train.py``'s lr 5e-5, with eps
1e-5, held to both sides.  Adam moves an element whose gradient is
float32 noise by up to lr whichever way the noise points (the reason
``tests/test_torch_train_mesh.py`` holds its steps to one process at lr
2e-6): at eps 1e-8 such elements put the sharded and one-process runs
2.05e-6 apart at lr 2e-6 (zamba2's embedding, a gradient 4.7e-9 of its
leaf's max) and the sharded and reference runs 1.14e-5 apart at lr 5e-5
(rwkv6).  At eps 1e-5 such an element moves by about 1e-4 lr and every
gradient above 1e-4 of a leaf's max as before, so one run of steps meets
both sides' tolerances, which are ``tests/test_torch_train_mesh.py``'s:
- against the port's one-process step: each step's loss and grad norm
  within 1e-6 relative, every parameter after the steps within 1e-6
  (3.6e-7 at most measured, the parameters moving 1.6e-4);
- against the reference's sharded step: ``tests/test_torch_train.py``'s,
  losses and grad norms 1e-5 relative, parameters 1e-5.
  mixtral's shard_map aux over two data blocks is their mean in the port
  and the first block's in the reference (ROADMAP Queue 3), so its
  reference loss is the port's less 0.01 x the sum over layers of (the
  blocks' mean aux - the first block's), as ``test_torch_moe_mesh.py``
  allows; its gradients, grad norms and parameters agree as they are.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs.archs import SMOKE as REF_SMOKE
from repro.models.registry import build_model as ref_build_model
from repro_torch.configs.archs import SMOKE
from repro_torch.launch import steps
from repro_torch.launch.collectives import COLLECTIVES
from repro_torch.models.convert import params_from_reference
from repro_torch.models.registry import build_model
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import MeshShape
from repro_torch.tree import leaves

import torch_mesh_ranks
import torch_ranks
from torch_mesh_ranks import blockwise
from torch_threads import one_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the reference's four configs take about 60 s alone, and the group its
# four configs' three steps about 50 s (DTensor's dispatch: about 3 s a
# step at these widths, 10 s for a config's first), several times that
# beside the suite's other workers; the limits only stop a hung process
REF_TIMEOUT = 900
RANK_TIMEOUT = 900
MESH = (2, 2)
# arch -> the config's moe_impl (None: as published)
ARCHS = {"rwkv6-7b": None, "zamba2-7b": None, "mixtral-8x7b": "shardmap",
         "whisper-large-v3": None}
OPT = dict(lr=5e-5, warmup_steps=1, total_steps=10, eps=1e-5)
B, S, STEPS = 4, 24, 3
TOL = 1e-6
REF_LOSS_TOL, REF_PARAM_TOL = 1e-5, 1e-5


def _cfg(arch):
    impl = ARCHS[arch]
    cfg = SMOKE[arch]
    return dataclasses.replace(cfg, moe_impl=impl) if impl else cfg


def _data_blocks(arch):
    """The batch blocks mixtral's shard_map path routes on its own."""
    return MESH[0] if _cfg(arch).moe_impl == "shardmap" else 1


@pytest.fixture(scope="module")
def case():
    """{arch: (reference leaves as numpy, the port's tree, the steps'
    batches as numpy)}."""
    out = {}
    for i, arch in enumerate(ARCHS):
        cfg = _cfg(arch)
        ref = ref_build_model(REF_SMOKE[arch])
        rng = np.random.default_rng(10 + i)
        tree = jax.tree.map(
            lambda a: np.asarray(a, np.float32)
            + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32),
            ref.init(jax.random.PRNGKey(0))[0])
        batches = {"tokens": rng.integers(1, cfg.vocab, (STEPS, B, S))
                   .astype(np.int32)}
        if cfg.family == "encdec":
            batches["frames"] = rng.standard_normal(
                (STEPS, B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
        out[arch] = (jax.tree.leaves(tree),
                     params_from_reference(cfg, tree, device="cpu"),
                     batches)
    return out


@pytest.fixture(scope="module")
def ref(case, tmp_path_factory):
    """The reference's sharded steps, the configs one after another in
    one subprocess, started first so that it runs beside the port's
    ranks."""
    d = tmp_path_factory.mktemp("train_families_ref")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    paths = []
    for arch, (ref_leaves, _, batches) in case.items():
        extra = {"impl": ARCHS[arch]} if ARCHS[arch] else {}
        np.savez(d / f"{arch}.npz", arch=arch, opt=json.dumps(OPT),
                 steps_only=True, **batches, **extra,
                 **{f"p{i}": a for i, a in enumerate(ref_leaves)})
        paths += [d / f"{arch}.npz", d / f"{arch}_out.npz"]
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_train_mesh_ref.py"),
         *map(str, paths)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    yield proc, {arch: d / f"{arch}_out.npz" for arch in case}
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ref_out(ref):
    proc, paths = ref
    try:
        _, err = proc.communicate(timeout=REF_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert proc.returncode == 0, err[-4000:]
    return {arch: dict(np.load(path)) for arch, path in paths.items()}


@pytest.fixture(scope="module")
def ranks(case, ref, tmp_path_factory):
    """{arch: [each rank's result]} from one spawned group of 4."""
    d = tmp_path_factory.mktemp("train_families_ranks")
    cells = {arch: {"cfg": dataclasses.asdict(_cfg(arch)), "params": params,
                    "batches": {k: torch.from_numpy(v)
                                for k, v in batches.items()}}
             for arch, (_, params, batches) in case.items()}
    torch.save({"cells": cells, "mesh": MESH, "opt": OPT}, d / "case.pt")
    res = torch_ranks.run_ranks(torch_mesh_ranks.train_families_rank, 4,
                                d / "work", str(d / "case.pt"),
                                timeout=RANK_TIMEOUT)
    return {arch: [r[arch] for r in res] for arch in ARCHS}


@pytest.fixture(scope="module")
def one(case):
    """{arch: the port's one-process steps}: losses, grad norms,
    parameters after them, and each step's layers' block auxes
    (mixtral)."""
    out = {}
    for arch, (_, params, batches) in case.items():
        model = build_model(_cfg(arch))
        params = jax.tree.map(torch.clone, params)
        opt_cfg = adamw.AdamWConfig(**OPT)
        state = adamw.init(opt_cfg, params)
        fn = steps.make_train_step(model, opt_cfg)
        losses, norms, auxes = [], [], []
        for i in range(STEPS):
            seen = []
            with blockwise(_data_blocks(arch), seen):
                params, state, m = fn(params, state, {
                    k: torch.from_numpy(v[i]) for k, v in batches.items()})
            # the forward's layers first, then the remat recompute's
            auxes.append(seen[:model.cfg.n_layers])
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out[arch] = {"losses": losses, "grad_norms": norms,
                     "params": leaves(params), "auxes": auxes}
    return out


def _rel(a, b):
    return abs(float(a) / float(b) - 1)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_ranks_cover_the_mesh_and_agree(ranks, arch):
    got = ranks[arch]
    assert sorted(r["coord"] for r in got) == [
        (i, j) for i in range(MESH[0]) for j in range(MESH[1])]
    for r in got[1:]:
        for key in ("losses", "grad_norms"):
            assert all(torch.equal(a, b) for a, b in
                       zip(r[key], got[0][key]))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_three_steps_match_one_process(ranks, one, arch):
    r0, want = ranks[arch][0], one[arch]
    assert len(r0["losses"]) == STEPS
    for got, w in zip(r0["losses"], want["losses"]):
        assert _rel(got, w) <= TOL
    for got, w in zip(r0["grad_norms"], want["grad_norms"]):
        assert _rel(got, w) <= TOL
    assert int(r0["step"]) == STEPS
    assert len(r0["params"]) == len(want["params"])
    for got, w in zip(r0["params"], want["params"]):
        assert got.shape == w.shape
        assert float((got - w).abs().max()) <= TOL


@pytest.mark.parametrize("arch", list(ARCHS))
def test_the_steps_move_the_parameters(case, one, arch):
    """The steps move the parameters by far more than either side's
    bound."""
    moved = max(float((a - b).abs().max())
                for a, b in zip(one[arch]["params"], leaves(case[arch][1])))
    assert moved > 10 * REF_PARAM_TOL


@pytest.mark.parametrize("arch", list(ARCHS))
def test_moments_are_their_parameters_blocks(ranks, case, arch):
    """ZeRO-1: each rank holds, on its device, the block of every moment
    that ``opt_state_specs`` lays out, in its parameter's placements."""
    params = case[arch][1]
    model = build_model(_cfg(arch))
    specs = steps.opt_state_specs(model.param_specs(),
                                  adamw.AdamWConfig(**OPT))
    want = leaves(steps.param_shardings(
        specs.m, params, MeshShape(("data", "model"), MESH)))
    assert any("Shard" in str(sh.placements) for sh in want)
    for r in ranks[arch]:
        moments = r["moments"]
        assert len(moments) == 2 * len(want)
        for (local, placement, dev, dtype), sh, p in zip(
                moments, want + want, leaves(params) * 2):
            assert local == sh.shard_shape(tuple(p.shape))
            assert placement == str(sh.placements)
            assert (dev, dtype) == ("cpu", "torch.float32")


@pytest.mark.parametrize("arch", list(ARCHS))
def test_every_collective_is_staged_and_counted(ranks, arch):
    """Every rank counts as many collectives for step 1, of the layout's
    kinds (FSDP's all-gathers of the weights and reduce-scatters of their
    gradients, tensor parallelism's all-reduces; their bytes differ
    between the data ranks where a dim splits unevenly over "data", as
    rwkv6's 3 rows do, 2 and 1), and ``PeerStaged`` took each functional
    collective of the steps through its table."""
    for r in ranks[arch]:
        c = r["collectives"]
        assert c["count"] == ranks[arch][0]["collectives"]["count"]
        assert c["count"] > 0
        for kind in ("all-gather", "all-reduce", "reduce-scatter"):
            assert c[kind] > 0, kind
        staged = r["staged"]
        assert staged and set(staged) <= set(COLLECTIVES)
        assert staged == ranks[arch][0]["staged"]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_sharded_steps_match_the_references(ranks, one, ref_out, case,
                                            arch):
    """Against the reference's sharded step: each step's loss (mixtral's
    less its aux gap) and grad norm, every parameter after the three
    steps."""
    r0, ref = ranks[arch][0], ref_out[arch]
    auxes = one[arch]["auxes"]
    for i, (got, want) in enumerate(zip(r0["losses"], ref["losses"])):
        got = float(got)
        if _data_blocks(arch) > 1:
            gap = 0.01 * sum(np.mean(a) - a[0] for a in auxes[i])
            print(f"{arch} step {i + 1}: aux gap {gap:.6e}; off by "
                  f"{abs(got - want):.3e} as it is, "
                  f"{abs(got - gap - want):.3e} less the gap")
            # the gap explains the difference, to far below its own size
            assert abs(got - gap - want) < 0.01 * abs(gap)
            got -= gap
        assert _rel(got, want) <= REF_LOSS_TOL
    for got, want in zip(r0["grad_norms"], ref["grad_norms"]):
        assert _rel(got, want) <= REF_LOSS_TOL
    assert len(r0["params"]) == len(case[arch][0])
    for i, p in enumerate(r0["params"]):
        assert float(np.abs(p.numpy() - ref[f"q{i}"]).max()) \
            <= REF_PARAM_TOL
