"""The shard_map MoE's backward over several ranks: the port's gradients
(``blocks.apply_moe_shardmap`` over gloo ranks) against the reference's
``jax.grad`` of its ``shard_map`` over the same 4-device meshes, on the
CPU.

The toy MoE block of ``tests/test_torch_moe_shardmap.py`` (d_model 64, 8
experts top-2, expert_d_ff 96), x [4, 16, 64] drawn from a seed; two
losses, the sum of the block's output and its aux (load-balance) loss,
which ``LM.train_loss`` adds at 0.01.  The reference runs in one fresh
subprocess (``tests/torch_moe_grad_ref.py``); the port's ranks are
spawned gloo groups of 2 and 4 (``tests/torch_ranks.py``,
``tests/torch_mesh_ranks.moe_grad_rank``), each rank taking the gradient
of its own batch block's output.

A rank holds its block's gradient.  What a data-parallel step gives
every rank of model coordinate m is held to the reference's gradient: x,
the router and the norm's scale whole on every m, each expert tensor on
m's slice (zero elsewhere).  For the output's sum that step sums over the
data ranks.  For aux it averages: the reference's aux is a ``P()`` output
of its ``shard_map`` under ``check_rep=False``, whose transpose scales
the cotangent by 1/|devices|, so its gradient is the mean of the data
blocks' aux gradients (while its value is the first data block's, which
``test_aux_is_the_first_data_blocks_and_its_gradient_their_mean`` pins
in both packages).  Tolerance: float32, 1e-5 of each leaf's max |g|.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.models.config import ModelConfig as RefModelConfig
from repro.models.registry import build_model as ref_build_model
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_reference

import torch_mesh_ranks
import torch_ranks
from torch_threads import one_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF_TIMEOUT = 300
GRAD_TOL = 1e-5
TOY = dict(name="m", family="moe", n_layers=1, d_model=64, n_heads=2,
           n_kv_heads=2, d_ff=64, vocab=128, n_experts=8, top_k=2,
           expert_d_ff=96, moe_strategy="ep")
GROUPS = {2: [(1, 2)], 4: [(1, 4), (2, 2)]}
CASES = [f"{d}x{m}/{s}" for w in GROUPS for d, m in GROUPS[w]
         for s in ("ep", "tp")]
LOSSES = ("y", "aux")
EXPERT = ("w_gate", "w_up", "w_down")
LEAVES = ("x", "router", "norm_scale") + EXPERT


def _block(tree, i=0):
    if isinstance(tree, dict):
        return {k: _block(v, i) for k, v in tree.items()}
    return tree[i]


@pytest.fixture(scope="module")
def toy():
    """(port MoE block, numpy arrays of the same block, x)."""
    cfg = RefModelConfig(**TOY)
    rp, _ = ref_build_model(cfg).init(jax.random.PRNGKey(0))
    rp = jax.tree.map(np.asarray, rp)
    tp = params_from_reference(ModelConfig(**TOY), rp, device="cpu")
    x = np.random.default_rng(1).standard_normal((4, 16, 64)).astype(
        np.float32)
    return _block(tp["units"][0]["moe"]), _block(rp["units"][0]["moe"]), x


@pytest.fixture(scope="module")
def ref(toy, tmp_path_factory):
    _, a, x = toy
    d = tmp_path_factory.mktemp("moe_grad_ref")
    np.savez(d / "case.npz", cfg=json.dumps(TOY), x=x,
             norm_scale=a["norm"]["scale"],
             **{k: a[k] for k in ("router",) + EXPERT})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_moe_grad_ref.py"),
         str(d / "case.npz"), str(d / "out.npz")], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=REF_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(d / "out.npz"))


@pytest.fixture(scope="module")
def port(toy, tmp_path_factory):
    """{case: [each rank's result]} from one spawned group a world size."""
    p, _, x = toy
    out = {}
    for world, meshes in GROUPS.items():
        d = tmp_path_factory.mktemp(f"grad_ranks{world}")
        torch.save({"cfg": TOY, "params": p, "x": torch.from_numpy(x),
                    "meshes": meshes}, d / "case.pt")
        ranks = torch_ranks.run_ranks(torch_mesh_ranks.moe_grad_rank, world,
                                      d / "work", str(d / "case.pt"))
        for case in ranks[0]:
            out[case] = [r[case] for r in ranks]
    return out


def _expert_slice(leaf, strategy, m, msize, shape):
    """The index of model rank m's slice of an expert tensor."""
    idx = [slice(None)] * len(shape)
    if strategy == "ep":
        n = shape[0] // msize
        idx[0] = slice(m * n, (m + 1) * n)
    else:
        ax = 1 if leaf == "w_down" else 2
        n = shape[ax] // msize
        idx[ax] = slice(m * n, (m + 1) * n)
    return tuple(idx)


def _data_step(ranks, loss, leaf, m, dp):
    """Model rank m's gradient of ``leaf`` after a data-parallel step: the
    data ranks' sum for the output's sum, their mean for aux."""
    got = sum(r["grads"][loss][leaf] for r in ranks
              if r["coord"][1] == m).numpy()
    return got / dp if loss == "aux" else got


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("case", CASES)
def test_rank_gradients_are_the_references(port, ref, case, loss):
    mesh, strategy = case.split("/")
    dp, mp = map(int, mesh.split("x"))
    ranks = port[case]
    assert sorted(r["coord"] for r in ranks) == [
        (i, m) for i in range(dp) for m in range(mp)]
    for leaf in LEAVES:
        want = ref[f"{case}/{loss}/{leaf}"]
        if loss == "aux" and leaf in EXPERT:
            # aux reads the router's probabilities only
            assert not want.any(), leaf
            assert not any(r["grads"][loss][leaf].any() for r in ranks)
            continue
        tol = GRAD_TOL * float(np.abs(want).max())
        assert tol > 0, leaf
        for m in range(mp):
            got = _data_step(ranks, loss, leaf, m, dp)
            if leaf in EXPERT:
                mine = _expert_slice(leaf, strategy, m, mp, want.shape)
                np.testing.assert_allclose(got[mine], want[mine], atol=tol,
                                           rtol=0, err_msg=f"{leaf} m={m}")
                rest = got.copy()
                rest[mine] = 0
                assert not rest.any(), f"{leaf}: rank {m} outside its slice"
            else:
                np.testing.assert_allclose(got, want, atol=tol, rtol=0,
                                           err_msg=f"{leaf} m={m}")


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("strategy", ["ep", "tp"])
@pytest.mark.parametrize("mesh", ["1x2", "1x4"])
def test_a_model_axis_alone_keeps_the_spmd_gradient(ref, port, mesh,
                                                    strategy, loss):
    """With one data block every token routes as in spmd, and splitting
    the experts over "model" leaves every gradient the spmd one, in both
    packages (the reference's psum transpose under ``check_rep=False``
    adds no factor of |model|)."""
    case = f"{mesh}/{strategy}"
    for leaf in LEAVES:
        want = ref[f"spmd/{strategy}/{loss}/{leaf}"]
        tol = GRAD_TOL * float(np.abs(want).max())
        np.testing.assert_allclose(ref[f"{case}/{loss}/{leaf}"], want,
                                   atol=tol, rtol=0,
                                   err_msg=f"reference {leaf}")
        got = sum(r["grads"][loss][leaf] for r in port[case]
                  if leaf in EXPERT or r["coord"][1] == 0).numpy()
        np.testing.assert_allclose(got, want, atol=tol, rtol=0,
                                   err_msg=f"port {leaf}")


@pytest.mark.parametrize("case", CASES)
def test_aux_is_the_first_data_blocks_and_its_gradient_their_mean(
        port, ref, case):
    """Each port rank's aux is its data block's, the same on every model
    rank.  The reference's one aux is the first data block's (its value
    equals the port's on data rank 0, and the spmd one only at one data
    block), while its gradient is the blocks' mean (held in
    ``test_rank_gradients_are_the_references``): a property of the
    reference's ``P()`` output under ``check_rep=False``, not of the
    port."""
    mesh, strategy = case.split("/")
    dp = int(mesh.split("x")[0])
    aux = {}
    for r in port[case]:
        aux.setdefault(r["coord"][0], set()).add(float(r["aux"]))
    assert all(len(v) == 1 for v in aux.values())
    want = float(ref[f"{case}/aux_value"])
    np.testing.assert_allclose(aux[0].pop(), want, rtol=1e-6)
    spmd = float(ref[f"spmd/{strategy}/aux_value"])
    if dp == 1:
        np.testing.assert_allclose(want, spmd, rtol=1e-6)
    else:
        assert abs(want - spmd) > 1e-4
