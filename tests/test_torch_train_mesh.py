"""The sharded train step: ``launch/steps.place_cell`` places the
qwen1.5-4b smoke config's train cell on a (data, model) mesh of gloo
ranks as DTensors, by ``build_cell``'s shardings (FSDP over "data", heads,
mlp and vocab over "model", ZeRO-1 moments, the batch over "data"), and
``make_train_step`` runs on it unchanged, each rank on its blocks.

The port's side runs on 4 spawned ranks (``tests/torch_ranks.py``, rank
body ``tests/torch_mesh_ranks.train_mesh_rank``), one group for the
meshes (2, 2), (4, 1) and (1, 4); no process group runs in the pytest
worker.  The reference's side runs in a fresh subprocess
(``tests/torch_train_mesh_ref.py``): its ``make_train_step`` jitted with
``param_shardings`` on its own 2 x 2 mesh of 4 XLA host devices.

Weights: the reference's ``init`` perturbed with numpy noise, carried
over by ``models/convert.params_from_reference``; tokens: numpy draws
from a seed, one [4, 24] batch a step.

Tolerances (float32):
- against the port's one-process step: the loss and grad norm within
  1e-6 relative, the parameters after three steps within 1e-6; each
  gradient leaf within 1e-5 of its max |g| and the prefill's logits
  within 1e-5 of their max (products summed over ranks' blocks in other
  orders: up to 1.2e-6 and 8.0e-7 measured);
- against the reference's sharded step: ``tests/test_torch_train.py``'s,
  at its lr 5e-5 (loss 1e-5 relative, gradients 1e-4 of a leaf's max,
  parameters 1e-5).

Adam divides each gradient element by its own magnitude, so an element
whose gradient is float32 noise moves by up to lr whichever way the noise
points: after three steps the sharded and one-process runs differ by up
to 0.27 lr from such elements alone (measured at lr 1e-5 and 5e-5), with
equal losses and grad norms.  The steps held to 1e-6 run at lr 2e-6, so
that part stays under the tolerance while the parameters move by up to
6e-6; the reference's run uses its test's lr 5e-5 and 1e-5.
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
from repro_torch.models.convert import params_from_reference
from repro_torch.models.registry import build_model
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import MeshShape
from repro_torch.tree import leaves

import torch_mesh_ranks
import torch_ranks
from torch_threads import one_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF_TIMEOUT = 300
# the group runs the three meshes in about 25 s alone; the limit only
# stops a hung collective
RANK_TIMEOUT = 300
ARCH = "qwen1.5-4b"
MESHES = [(2, 2), (4, 1), (1, 4)]
IDS = [f"{d}x{m}" for d, m in MESHES]
STEP_OPT = dict(lr=2e-6, warmup_steps=1, total_steps=10)
REF_OPT = dict(lr=5e-5, warmup_steps=1, total_steps=10)
B, S, STEPS = 4, 24, 3
TOL = 1e-6
BLOCK_TOL = 1e-5
REF_LOSS_TOL, REF_GRAD_TOL, REF_PARAM_TOL = 1e-5, 1e-4, 1e-5


@pytest.fixture(scope="module")
def case():
    """(reference parameter leaves as numpy, the port's tree, tokens)."""
    ref = ref_build_model(REF_SMOKE[ARCH])
    rng = np.random.default_rng(0)
    tree = jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32),
        ref.init(jax.random.PRNGKey(0))[0])
    tokens = np.random.default_rng(1).integers(
        1, SMOKE[ARCH].vocab, (STEPS, B, S)).astype(np.int32)
    return (jax.tree.leaves(tree),
            params_from_reference(SMOKE[ARCH], tree, device="cpu"), tokens)


@pytest.fixture(scope="module")
def ref(case, tmp_path_factory):
    """The reference's sharded step on its 2 x 2 mesh, started first so it
    runs beside the port's ranks."""
    ref_leaves, _, tokens = case
    d = tmp_path_factory.mktemp("train_mesh_ref")
    np.savez(d / "case.npz", tokens=tokens, opt=json.dumps(REF_OPT),
             **{f"p{i}": a for i, a in enumerate(ref_leaves)})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_train_mesh_ref.py"),
         str(d / "case.npz"), str(d / "out.npz")], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc, d / "out.npz"
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ref_out(ref):
    proc, path = ref
    try:
        _, err = proc.communicate(timeout=REF_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert proc.returncode == 0, err[-4000:]
    return dict(np.load(path))


@pytest.fixture(scope="module")
def ranks(case, ref, tmp_path_factory):
    """{mesh id: [each rank's result]} from one spawned group of 4."""
    _, params, tokens = case
    d = tmp_path_factory.mktemp("train_mesh_ranks")
    torch.save({"cfg": dataclasses.asdict(SMOKE[ARCH]), "params": params,
                "tokens": torch.from_numpy(tokens), "opt": STEP_OPT,
                "ref_opt": REF_OPT, "meshes": MESHES}, d / "case.pt")
    res = torch_ranks.run_ranks(torch_mesh_ranks.train_mesh_rank, 4,
                                d / "work", str(d / "case.pt"),
                                timeout=RANK_TIMEOUT)
    return {k: [r[k] for r in res] for k in res[0]}


@pytest.fixture(scope="module")
def one(case):
    """The port's one-process run: train_loss and its gradient, the three
    steps, the prefill."""
    _, params, tokens = case
    model = build_model(SMOKE[ARCH])
    params = jax.tree.map(torch.clone, params)
    first = {"tokens": torch.from_numpy(tokens[0])}
    loss0, grads0 = steps._value_and_grad(model, params, first, True)
    with torch.no_grad():
        prefill = steps.make_prefill(model)(params, first)
    opt = adamw.AdamWConfig(**STEP_OPT)
    state = adamw.init(opt, params)
    fn = steps.make_train_step(model, opt)
    losses, norms = [], []
    for toks in tokens:
        params, state, m = fn(params, state,
                              {"tokens": torch.from_numpy(toks)})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"loss0": float(loss0), "grads0": grads0, "losses": losses,
            "grad_norms": norms, "params": leaves(params),
            "prefill": prefill}


def _rel(a, b):
    return abs(float(a) / float(b) - 1)


@pytest.mark.parametrize("mesh", IDS)
def test_ranks_cover_the_mesh_and_agree(ranks, mesh):
    d, m = map(int, mesh.split("x"))
    got = ranks[mesh]
    assert sorted(r["coord"] for r in got) == [
        (i, j) for i in range(d) for j in range(m)]
    for r in got[1:]:
        assert torch.equal(r["loss0"], got[0]["loss0"])
        assert all(torch.equal(a, b) for a, b in
                   zip(r["losses"], got[0]["losses"]))
        assert torch.equal(r["prefill"], got[0]["prefill"])


@pytest.mark.parametrize("mesh", IDS)
def test_train_loss_and_grads_match_one_process(ranks, one, mesh):
    r0 = ranks[mesh][0]
    assert _rel(r0["loss0"], one["loss0"]) <= TOL
    assert len(r0["grads0"]) == len(one["grads0"])
    for g, w in zip(r0["grads0"], one["grads0"]):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= BLOCK_TOL * float(w.abs().max())


@pytest.mark.parametrize("mesh", IDS)
def test_three_steps_match_one_process(ranks, one, mesh):
    r0 = ranks[mesh][0]
    for got, want in zip(r0["losses"], one["losses"]):
        assert _rel(got, want) <= TOL
    for got, want in zip(r0["grad_norms"], one["grad_norms"]):
        assert _rel(got, want) <= TOL
    assert int(r0["step"]) == STEPS
    for got, want in zip(r0["params"], one["params"]):
        assert float((got - want).abs().max()) <= TOL


def test_microbatched_step_matches_one_process(ranks, case):
    """``make_train_step(microbatches=2)`` on the (2, 2) mesh: the batch's
    halves, float32 gradients summed over them, against one process."""
    _, params, tokens = case
    model = build_model(SMOKE[ARCH])
    params = jax.tree.map(torch.clone, params)
    opt = adamw.AdamWConfig(**STEP_OPT)
    params, _, m = steps.make_train_step(model, opt, microbatches=2)(
        params, adamw.init(opt, params),
        {"tokens": torch.from_numpy(tokens[0])})
    got = ranks["2x2"][0]["microbatched"]
    assert _rel(got["loss"], m["loss"]) <= TOL
    assert _rel(got["grad_norm"], m["grad_norm"]) <= TOL
    for a, b in zip(got["params"], leaves(params)):
        assert float((a - b).abs().max()) <= TOL


def test_the_steps_move_the_parameters(case, one):
    moved = max(float((a - b).abs().max())
                for a, b in zip(one["params"], leaves(case[1])))
    assert moved > 5 * TOL


@pytest.mark.parametrize("mesh", IDS)
def test_prefill_matches_one_process(ranks, one, mesh):
    got, want = ranks[mesh][0]["prefill"], one["prefill"]
    assert got.shape == want.shape == (B, SMOKE[ARCH].vocab)
    assert float((got - want).abs().max()) <= \
        BLOCK_TOL * float(want.abs().max())


@pytest.mark.parametrize("mesh", IDS)
def test_moments_are_their_parameters_blocks(ranks, case, mesh):
    """ZeRO-1: each rank holds, on its device, the block of every moment
    that ``opt_state_specs`` lays out, in the parameters' placements."""
    _, params, _ = case
    d, m = map(int, mesh.split("x"))
    model = build_model(SMOKE[ARCH])
    shape = MeshShape(("data", "model"), (d, m))
    specs = steps.opt_state_specs(model.param_specs(),
                                  adamw.AdamWConfig(**STEP_OPT))
    want = leaves(steps.param_shardings(specs.m, params, shape))
    for r in ranks[mesh]:
        moments = r["moments"]
        assert len(moments) == 2 * len(want)
        for (local, placement, dev, dtype), sh, p in zip(
                moments, want + want, leaves(params) * 2):
            assert local == sh.shard_shape(tuple(p.shape))
            assert placement == str(sh.placements)
            assert (dev, dtype) == ("cpu", "torch.float32")
        assert [pl for _, pl in r["param_layout"]] == \
            [pl for _, pl, _, _ in moments[:len(want)]]


@pytest.mark.parametrize("mesh", IDS)
def test_attention_kernel_gets_each_ranks_block(ranks, mesh):
    """Every call of the attention kernel (each layer, forward and the
    remat recompute) is handed plain local blocks: batch over "data",
    heads over "model"."""
    d, m = map(int, mesh.split("x"))
    cfg = SMOKE[ARCH]
    q = (B // d, cfg.n_heads // m, S, cfg.hd)
    k = (B // d, cfg.n_kv_heads // m, S, cfg.hd)
    for r in ranks[mesh]:
        assert len(r["blocks"]) == 2 * cfg.n_layers
        assert set(r["blocks"]) == {(q, k, "Tensor")}


@pytest.mark.parametrize("mesh", IDS)
def test_step_collectives_are_counted(ranks, mesh):
    """Every rank counts the same collectives for a step, of the kinds the
    layout needs: all-reduces (the loss, the norm, tensor parallelism's
    partial sums) and, where "data" splits the weights (FSDP),
    all-gathers of them and reduce-scatters of their gradients."""
    counts = [r["collectives"] for r in ranks[mesh]]
    assert all(c == counts[0] for c in counts)
    c = counts[0]
    assert set(c) == {"all-gather", "all-reduce", "reduce-scatter",
                      "all-to-all", "collective-permute", "count"}
    assert c["count"] > 0 and c["all-reduce"] > 0
    if not mesh.startswith("1x"):
        assert c["all-gather"] > 0 and c["reduce-scatter"] > 0


def test_step_collectives_beside_the_references(ranks, ref_out):
    """The 2 x 2 step's collectives a device: the port's (DTensor's eager
    layouts, the counter) beside the reference's ``collective_bytes`` of
    its jitted step (XLA's partitioner, on the CPU backend, which forms no
    reduce-scatter).  Same keys; both gather the FSDP weights and
    all-reduce partial sums."""
    port = ranks["2x2"][0]["collectives"]
    ref = json.loads(str(ref_out["collectives"]))
    print(f"2 x 2 step, bytes a device: port {port}; reference {ref}")
    assert set(ref) == set(port) | {"count_static"}
    for c in (port, ref):
        assert c["count"] > 0 and c["all-gather"] > 0 and c["all-reduce"] > 0


def test_sharded_step_matches_the_references(ranks, ref_out, case):
    r0 = ranks["2x2"][0]
    assert _rel(r0["loss0"], ref_out["loss0"]) <= REF_LOSS_TOL
    for i, g in enumerate(r0["grads0"]):
        w = ref_out[f"g{i}"]
        assert float(np.abs(g.numpy() - w).max()) <= \
            REF_GRAD_TOL * float(np.abs(w).max())
    run = r0["ref_run"]
    for got, want in zip(run["losses"], ref_out["losses"]):
        assert _rel(got, want) <= REF_LOSS_TOL
    for got, want in zip(run["grad_norms"], ref_out["grad_norms"]):
        assert _rel(got, want) <= REF_LOSS_TOL
    for i, p in enumerate(run["params"]):
        assert float(np.abs(p.numpy() - ref_out[f"q{i}"]).max()) \
            <= REF_PARAM_TOL
    moved = max(float((a - b).abs().max())
                for a, b in zip(run["params"], leaves(case[1])))
    assert moved > 10 * REF_PARAM_TOL
