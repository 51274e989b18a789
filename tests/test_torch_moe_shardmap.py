"""The port's shard_map MoE (``blocks.apply_moe_shardmap``) over real
``torch.distributed`` meshes against the reference's ``shard_map``, on
the CPU.

The toy MoE of ``tests/test_moe_paths.py`` (d_model 64, 8 experts top-2,
expert_d_ff 96) as a one-layer LM: the reference draws it and its MoE
block is carried over with ``convert.params_from_reference``; x [4, 16,
64] is a numpy draw from a seed.  The reference runs in one fresh
subprocess with 4 XLA host devices (``tests/torch_mesh_ref.py moe``);
the port's ranks are spawned child processes in gloo groups
(``tests/torch_ranks.py``), one group of 1, 2 and 4 ranks, each joined
under a 120 s limit.  No process group is opened in the test process.

Tolerances: 1e-5 on y, 1e-6 on aux, expert choices equal through y and
the (1, 1) bit-equality with the port's own spmd path; gradients at (1, 1)
within 1e-4 of spmd's.
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

from repro.models import blocks as ref_blocks
from repro.models.config import ModelConfig as RefModelConfig
from repro.models.registry import build_model as ref_build_model
from repro_torch.models import blocks
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_reference
from repro_torch.parallel.sharding import MeshShape, use_mesh

import torch_ranks
from torch_threads import one_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF_TIMEOUT = 300
Y_TOL, AUX_TOL, GRAD_TOL = 1e-5, 1e-6, 1e-4
TOY = dict(name="m", family="moe", n_layers=1, d_model=64, n_heads=2,
           n_kv_heads=2, d_ff=64, vocab=128, n_experts=8, top_k=2,
           expert_d_ff=96, moe_strategy="ep")
GROUPS = {1: [(1, 1)], 2: [(1, 2)], 4: [(1, 4), (2, 2)]}
CASES = [f"{d}x{m}/{s}" for w in GROUPS for d, m in GROUPS[w]
         for s in ("ep", "tp")]


def _block(tree, i=0):
    """Layer ``i`` of the stacked MoE block."""
    if isinstance(tree, dict):
        return {k: _block(v, i) for k, v in tree.items()}
    return tree[i]


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """(port MoE block, numpy arrays of the same block, x)."""
    cfg = RefModelConfig(**TOY)
    rp, _ = ref_build_model(cfg).init(jax.random.PRNGKey(0))
    rp = jax.tree.map(np.asarray, rp)
    tp = params_from_reference(ModelConfig(**TOY), rp, device="cpu")
    p = _block(tp["units"][0]["moe"])
    arrays = _block(rp["units"][0]["moe"])
    x = np.random.default_rng(1).standard_normal((4, 16, 64)).astype(
        np.float32)
    return p, arrays, x


@pytest.fixture(scope="module")
def ref(toy, tmp_path_factory):
    _, a, x = toy
    d = tmp_path_factory.mktemp("moe_ref")
    np.savez(d / "case.npz", cfg=json.dumps(TOY), x=x,
             norm_scale=a["norm"]["scale"],
             **{k: a[k] for k in ("router", "w_gate", "w_up", "w_down")})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_mesh_ref.py"), "moe",
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
        d = tmp_path_factory.mktemp(f"ranks{world}")
        torch.save({"cfg": TOY, "params": p, "x": torch.from_numpy(x),
                    "meshes": meshes}, d / "case.pt")
        ranks = torch_ranks.run_ranks(torch_ranks.moe_rank, world,
                                      d / "work", str(d / "case.pt"))
        for case in ranks[0]:
            out[case] = [r[case] for r in ranks]
    return out


@pytest.mark.parametrize("case", CASES)
def test_shardmap_matches_the_reference(port, ref, toy, case):
    mesh, strategy = case.split("/")
    dp, mp = map(int, mesh.split("x"))
    want_y, want_aux = ref[f"{case}/y"], ref[f"{case}/aux"]
    b = want_y.shape[0] // dp
    assert len(port[case]) == dp * mp
    for r in port[case]:
        data, model = r["coord"]
        got = r["y"].numpy()
        assert got.shape == (b,) + want_y.shape[1:]
        np.testing.assert_allclose(got, want_y[data * b:(data + 1) * b],
                                   atol=Y_TOL, rtol=0)
        np.testing.assert_allclose(float(r["aux"]),
                                   float(ref[f"{case}/aux{data}"]),
                                   atol=AUX_TOL, rtol=0)
        # the reference returns device (0, 0)'s aux (out_specs=P())
        if data == 0:
            np.testing.assert_allclose(float(r["aux"]), float(want_aux),
                                       atol=AUX_TOL, rtol=0)
        assert r["all_reduces"] == 1


@pytest.mark.parametrize("strategy", ["ep", "tp"])
def test_data_axis_departs_from_spmd_as_the_reference_does(
        port, ref, toy, strategy):
    """Under a data axis of 2 each block routes alone, with capacity from
    its own token count: not the spmd function, by the same amount in both
    packages."""
    p, _, x = toy
    cfg = ModelConfig(**dict(TOY, moe_strategy=strategy))
    y_spmd, _ = blocks.apply_moe_spmd(cfg, p, torch.from_numpy(x))
    got = np.concatenate([r["y"].numpy() for r in port[f"2x2/{strategy}"]
                          if r["coord"][1] == 0])
    ref_gap = np.abs(ref[f"2x2/{strategy}/y"] - ref[f"spmd/{strategy}/y"])
    port_gap = np.abs(got - y_spmd.numpy())
    assert ref_gap.max() > 1e-3
    np.testing.assert_allclose(port_gap.max(), ref_gap.max(), atol=Y_TOL)


@pytest.mark.parametrize("strategy", ["ep", "tp"])
def test_one_rank_shardmap_is_bit_equal_to_spmd(port, strategy):
    (r,) = port[f"1x1/{strategy}"]
    assert torch.equal(r["y"], r["y_spmd"])
    assert torch.equal(r["aux"], r["aux_spmd"])
    # a smoke LM's prefill under the mesh, one all-reduce a MoE layer
    assert torch.equal(r["lm_shardmap"], r["lm_spmd"])
    assert r["lm_all_reduces"] == 3


@pytest.mark.parametrize("strategy", ["ep", "tp"])
def test_grads_flow_through_a_one_rank_mesh(port, strategy):
    (r,) = port[f"1x1/{strategy}"]
    assert r["g_shardmap"].keys() == r["g_spmd"].keys()
    for k, g in r["g_shardmap"].items():
        want = r["g_spmd"][k]
        assert float(want.abs().max()) > 0, k
        np.testing.assert_allclose(g.numpy(), want.numpy(), atol=GRAD_TOL,
                                   rtol=GRAD_TOL)


@pytest.mark.parametrize("mesh", [
    None, MeshShape(("data",), (2,)), MeshShape(("data", "model"), (1, 3))])
def test_moe_impl_dispatch_falls_back_to_spmd(toy, mesh):
    """No mesh, a mesh without "model", or EP with |model| not dividing E:
    spmd, in both packages."""
    p, a, x = toy
    cfg = ModelConfig(**TOY)
    cfg_sm = dataclasses.replace(cfg, moe_impl="shardmap")
    xt = torch.from_numpy(x)
    before = blocks.apply_moe_shardmap.all_reduces
    if mesh is None:
        y1, _ = blocks.apply_moe(cfg_sm, p, xt)
    else:
        with use_mesh(mesh):
            y1, _ = blocks.apply_moe(cfg_sm, p, xt)
    y0, _ = blocks.apply_moe(cfg, p, xt)
    assert torch.equal(y1, y0)
    assert blocks.apply_moe_shardmap.all_reduces == before
    rcfg = dataclasses.replace(RefModelConfig(**TOY), moe_impl="shardmap")
    ry, _ = ref_blocks.apply_moe(rcfg, jax.tree.map(jax.numpy.asarray, a),
                                 jax.numpy.asarray(x))
    np.testing.assert_allclose(y1.numpy(), np.asarray(ry), atol=Y_TOL,
                               rtol=0)


def test_dispatch_takes_shardmap_when_the_mesh_allows(toy):
    """TP always, EP when |model| divides E; a MeshShape has no ranks, so
    the shard_map path refuses it rather than compute without them."""
    p, _, x = toy
    for strategy, mesh in [("tp", MeshShape(("data", "model"), (1, 3))),
                           ("ep", MeshShape(("data", "model"), (2, 4)))]:
        cfg = ModelConfig(**dict(TOY, moe_strategy=strategy,
                                 moe_impl="shardmap"))
        with use_mesh(mesh), pytest.raises(TypeError, match="DeviceMesh"):
            blocks.apply_moe(cfg, p, torch.from_numpy(x))


def test_hung_rank_is_killed_at_the_limit(tmp_path):
    with pytest.raises(TimeoutError):
        torch_ranks.run_ranks(torch_ranks.sleep_rank, 2, tmp_path, 30.0,
                              timeout=5.0)
