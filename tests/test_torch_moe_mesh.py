"""The MoE family on a mesh: ``launch/steps.place_cell`` places the
decode, prefill and train cells of the mixtral-8x7b (TP: every expert's
ff dim over "model") and kimi-k2 (EP: the experts over "model") smoke
configs on a (data, model) mesh of gloo ranks as DTensors, by
``build_cell``'s shardings, and the steps run on them unchanged;
``DecodeEngine.generate`` runs on the placed parameters.  Each config
runs as it is (``moe_impl="spmd"``) and with ``moe_impl="shardmap"``
(``dataclasses.replace``, the reference's own ``--moe-impl`` override):

- spmd (``blocks._moe_spmd_placed``) keeps one program's semantics, as
  XLA's partitioner keeps them in the reference's sharded cell: the
  top-k, the capacity and the stable sort over all T tokens of the global
  batch, the expert products on the expert or ff blocks;
- shard_map (``blocks._moe_shardmap_placed``) routes each rank's batch
  block against its experts or ff slice, the capacity from the block's
  own tokens, and one all-reduce over "model" a layer.  Its one-process
  counterpart is the same routing block by block (:func:`blockwise`):
  ``apply_moe_spmd`` on each batch block of the mesh's data axis, aux
  their mean.

The port's side runs on 4 spawned ranks (``tests/torch_ranks.py``, rank
body ``tests/torch_mesh_ranks.cells_mesh_rank``), one group for the
meshes (2, 2), (4, 1) and (1, 4); no process group runs in the pytest
worker.  The reference's side runs in fresh subprocesses with 4 XLA host
devices: its decode cells (``tests/torch_decode_mesh_ref.py``) and its
train gradients (``tests/torch_train_mesh_ref.py``) jitted with their
shardings on its own 2 x 2 mesh, under its mesh, so that a shardmap
config takes its ``shard_map``.

Weights: the reference's ``init`` perturbed with numpy noise, carried
over by ``models/convert.params_from_reference``; tokens: numpy draws
from a seed.  Decode: batch 4 with 16 cache slots; mixtral's batch-1
cases (``long_500k``'s layout: the KV sequence over "data", 8 or 4 slots
a data rank, the window's ring of 16 slots) take 20 tokens, so their
writes cross blocks and the ring wraps.  The train cells drop
assignments in one process (``MoERoute.dropped() > 0``).

Tolerances (float32), PR 29's:
- against the port's one process: every decode step's logits, the
  prefill's and the train loss within 1e-5 of their max |value|, every
  cache block and every gradient leaf within 1e-5 of the leaf's max (the
  TP products' partial sums over "model" add in other orders); with a
  planted fault (the spmd capacity cut to a batch block's, or
  ``Replicate`` for the router's ``Partial`` gradient placements) a
  gradient leaf is off by far more;
- against the reference's sharded cells: 1e-4, absolute and relative for
  the decode, of a leaf's max for the gradients; generated tokens equal.
  The shard_map path's aux over several data blocks is each block's own
  in the port (their mean here) and the first block's in the reference
  (ROADMAP Queue 3), so at 2 x 2 the reference's loss is the port's less
  0.01 x the sum over layers of (the blocks' mean aux - the first
  block's): 9.2e-5 (kimi-k2) and 4.8e-4 (mixtral) of the loss on these
  cells, which the prediction leaves at 2.6e-7 and 6.7e-7.  The
  gradients agree as they are.
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
from repro_torch.models import blocks
from repro_torch.models.convert import params_from_reference
from repro_torch.models.registry import build_model
from repro_torch.parallel.sharding import MeshShape
from repro_torch.serve.engine import DecodeEngine, ServeConfig
from repro_torch.tree import leaves

import torch_mesh_ranks
import torch_ranks
from torch_mesh_ranks import blockwise
from torch_threads import one_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF_TIMEOUT = 300
# the group runs every case in about a minute beside the references'
# subprocesses; the limit only stops a hung collective
RANK_TIMEOUT = 300
MESHES = [(2, 2), (4, 1), (1, 4)]
PLANT = [(2, 2), (4, 1)]
SEQ = 16
# variant -> (arch, moe_impl)
VARIANTS = {"mixtral-8x7b": ("mixtral-8x7b", "spmd"),
            "mixtral-8x7b-shardmap": ("mixtral-8x7b", "shardmap"),
            "kimi-k2": ("kimi-k2-1t-a32b", "spmd"),
            "kimi-k2-shardmap": ("kimi-k2-1t-a32b", "shardmap")}
ARCHS = sorted({a for a, _ in VARIANTS.values()})
# decode case -> (variant, batch, teacher-forced tokens, prompt lengths,
# generated, meshes)
CASES = {v: (v, 4, 10, (6, 4, 5, 6), 4, MESHES) for v in VARIANTS}
CASES.update({
    "mixtral-8x7b-seq": ("mixtral-8x7b", 1, 20, (12,), 8, [(2, 2), (4, 1)]),
    "mixtral-8x7b-shardmap-seq": ("mixtral-8x7b-shardmap", 1, 20, (12,), 8,
                                  [(2, 2)])})
B, S = 4, 24              # the train and prefill cells' tokens
COUNT_AT = 2
TOL = 1e-5
REF_TOL = 1e-4
DECODE_IDS = [f"{c}/{d}x{m}" for c, spec in CASES.items()
              for d, m in spec[-1]]
CELL_IDS = [f"cell/{v}/{d}x{m}" for v in VARIANTS for d, m in MESHES]
PLANT_IDS = [f"cell/{v}/{d}x{m}" for v in VARIANTS for d, m in PLANT]


def _cfg(variant):
    arch, impl = VARIANTS[variant]
    return dataclasses.replace(SMOKE[arch], moe_impl=impl)


def _prompts(cfg, b, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab, n).astype(np.int32).tolist()
            for n in lengths[:b]]


def _left_padded(prompts):
    plen = max(len(p) for p in prompts)
    out = np.zeros((len(prompts), plen), np.int32)
    for i, p in enumerate(prompts):
        out[i, plen - len(p):] = p
    return out


def _paths(tree, prefix=""):
    """Each leaf's path, in ``leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (tuple, list)):
        return [p for i, t in enumerate(tree)
                for p in _paths(t, f"{prefix}/{i}")]
    return [prefix]


def _perturbed(arch):
    """(reference leaves as numpy, the port's tree)."""
    ref = ref_build_model(REF_SMOKE[arch])
    rng = np.random.default_rng(0)
    tree = jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32),
        ref.init(jax.random.PRNGKey(0))[0])
    return (jax.tree.leaves(tree),
            params_from_reference(SMOKE[arch], tree, device="cpu"))


def _one_blocks(variant, mesh):
    """The batch blocks of the variant's one-process counterpart."""
    return mesh[0] if VARIANTS[variant][1] == "shardmap" else 1


@pytest.fixture(scope="module")
def weights():
    return {arch: _perturbed(arch) for arch in ARCHS}


@pytest.fixture(scope="module")
def case():
    """{decode case: (tokens, prompts)}, {variant: train tokens [B, S]}."""
    decode = {}
    for n, (v, b, t, lengths, _, _) in CASES.items():
        cfg = _cfg(v)
        tokens = np.random.default_rng(1).integers(
            1, cfg.vocab, (b, t)).astype(np.int32)
        decode[n] = (tokens, _prompts(cfg, b, lengths, 2))
    cells = {v: np.random.default_rng(3).integers(
        1, _cfg(v).vocab, (B, S)).astype(np.int32) for v in VARIANTS}
    return decode, cells


def _popen(script, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / script), *map(str, args)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


@pytest.fixture(scope="module")
def ref(weights, case, tmp_path_factory):
    """The reference's sharded decode cells and train gradients on its 2 x
    2 mesh, started first so they run beside the port's ranks."""
    decode, cells = case
    d = tmp_path_factory.mktemp("moe_mesh_ref")
    names = [n for n in CASES if (2, 2) in CASES[n][-1]]
    arrays = {"names": json.dumps(names)}
    for n in names:
        tokens, prompts = decode[n]
        arch, impl = VARIANTS[CASES[n][0]]
        arrays.update({f"{n}__arch": arch, f"{n}__impl": impl,
                       f"{n}__seq": SEQ, f"{n}__tokens": tokens,
                       f"{n}__gen": CASES[n][4],
                       f"{n}__prompts": _left_padded(prompts)})
        arrays.update({f"{n}__p{i}": a
                       for i, a in enumerate(weights[arch][0])})
    np.savez(d / "decode.npz", **arrays)
    procs = {"decode": (_popen("torch_decode_mesh_ref.py", d / "decode.npz",
                               d / "decode_out.npz"), d / "decode_out.npz")}
    for v, (arch, impl) in VARIANTS.items():
        np.savez(d / f"{v}.npz", arch=arch, impl=impl, grads_only=True,
                 tokens=cells[v][None],
                 opt=json.dumps(dict(lr=1e-5, warmup_steps=1,
                                     total_steps=10)),
                 **{f"p{i}": a for i, a in enumerate(weights[arch][0])})
        procs[v] = (_popen("torch_train_mesh_ref.py", d / f"{v}.npz",
                           d / f"{v}_out.npz"), d / f"{v}_out.npz")
    yield procs
    for proc, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _ref_out(ref, name):
    proc, path = ref[name]
    try:
        _, err = proc.communicate(timeout=REF_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert proc.returncode == 0, err[-4000:]
    return dict(np.load(path))


@pytest.fixture(scope="module")
def ref_decode(ref):
    return _ref_out(ref, "decode")


@pytest.fixture(scope="module")
def ref_train(ref):
    return {v: _ref_out(ref, v) for v in VARIANTS}


@pytest.fixture(scope="module")
def ranks(weights, case, ref, tmp_path_factory):
    """{case/mesh or cell/variant/mesh: [each rank's result]} from one
    spawned group of 4."""
    decode, cells = case
    d = tmp_path_factory.mktemp("moe_mesh_ranks")
    dec = {}
    for n, (tokens, prompts) in decode.items():
        v, _, _, _, gen, meshes = CASES[n]
        dec[n] = {"cfg": dataclasses.asdict(_cfg(v)),
                  "params": weights[VARIANTS[v][0]][1], "seq": SEQ,
                  "tokens": torch.from_numpy(tokens), "prompts": prompts,
                  "gen": gen, "meshes": meshes, "count_at": COUNT_AT}
    cell = {v: {"cfg": dataclasses.asdict(_cfg(v)),
                "params": weights[VARIANTS[v][0]][1],
                "batch": {"tokens": torch.from_numpy(cells[v])},
                "meshes": MESHES,
                "plant": ("capacity" if VARIANTS[v][1] == "spmd"
                          else "replicate", PLANT)} for v in VARIANTS}
    torch.save({"decode": dec, "cells": cell}, d / "case.pt")
    res = torch_ranks.run_ranks(torch_mesh_ranks.cells_mesh_rank, 4,
                                d / "work", str(d / "case.pt"),
                                timeout=RANK_TIMEOUT)
    return {k: [r[k] for r in res] for k in res[0]}


def _one_decode(variant, params, tokens, prompts, b, gen, n):
    cfg = _cfg(variant)
    model = build_model(cfg)
    with blockwise(n):
        caches = model.init_cache(b, SEQ, torch.float32, device="cpu")
        logits = []
        for t in range(tokens.shape[1]):
            lg, caches = model.decode_step(
                params, caches, torch.from_numpy(tokens[:, t:t + 1]))
            logits.append(lg)
        engine = DecodeEngine(model, params, ServeConfig(max_seq=SEQ,
                                                         batch=b),
                              device="cpu")
        seen = []
        step = model.decode_step

        def recorded(*args):
            lg, c = step(*args)
            seen.append(lg)
            return lg, c

        model.decode_step = recorded
        generated = engine.generate(prompts, gen)
    plen = max(len(p) for p in prompts)
    return {"logits": torch.stack(logits), "caches": leaves(caches),
            "generated": generated,
            "picks": torch.stack(seen[plen - 1:plen - 1 + gen])}


@pytest.fixture(scope="module")
def one(weights, case):
    """The port's one-process runs, keyed ``(case, batch blocks)``: each
    decode case's steps, caches and generation; each variant's train
    loss, gradients, prefill, the block auxes a layer and the
    assignments its routing drops."""
    decode, cells = case
    out = {}
    for n, (tokens, prompts) in decode.items():
        v, b, _, _, gen, meshes = CASES[n]
        for nb in {_one_blocks(v, m) for m in meshes}:
            out[n, nb] = _one_decode(v, weights[VARIANTS[v][0]][1], tokens,
                                     prompts, b, gen, nb)
    for v in VARIANTS:
        params = weights[VARIANTS[v][0]][1]
        model = build_model(_cfg(v))
        batch = {"tokens": torch.from_numpy(cells[v])}
        for nb in {_one_blocks(v, m) for m in MESHES}:
            auxes, dropped = [], []
            route = blocks.moe_route

            def counted(*args, **kw):
                r = route(*args, **kw)
                dropped.append(r.dropped())
                return r

            with blockwise(nb):
                loss, grads = steps._value_and_grad(model, params, batch,
                                                    True)
                with torch.no_grad():
                    prefill = steps.make_prefill(model)(params, batch)
            blocks.moe_route = counted
            try:
                with blockwise(nb, auxes), torch.no_grad():
                    model.train_loss(params, batch, remat=False)
            finally:
                blocks.moe_route = route
            out[f"cell/{v}", nb] = {"loss": loss, "grads": grads,
                                    "prefill": prefill, "auxes": auxes,
                                    "dropped": sum(dropped),
                                    "paths": _paths(params)}
    return out


def _split(cid):
    """(decode case or ``cell/<variant>``, mesh) of a result's id."""
    n, mesh = cid.rsplit("/", 1)
    return n, tuple(map(int, mesh.split("x")))


def _one(one, cid):
    n, mesh = _split(cid)
    v = n[5:] if n.startswith("cell/") else CASES[n][0]
    return one[n, _one_blocks(v, mesh)]


def _rel(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                   1e-30)


@pytest.mark.parametrize("cid", DECODE_IDS + CELL_IDS)
def test_ranks_cover_the_mesh_and_agree(ranks, cid):
    _, (d, m) = _split(cid)
    got = ranks[cid]
    assert sorted(r["coord"] for r in got) == [
        (i, j) for i in range(d) for j in range(m)]
    for key in ("logits", "generated", "loss", "prefill"):
        if key in got[0]:
            for r in got[1:]:
                assert torch.equal(r[key], got[0][key]), key


@pytest.mark.parametrize("cid", DECODE_IDS)
def test_decode_steps_match_one_process(ranks, one, cid):
    got, want = ranks[cid][0]["logits"], _one(one, cid)["logits"]
    assert got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    for g, w in zip(got, want):
        assert _rel(g, w) <= TOL


@pytest.mark.parametrize("cid", DECODE_IDS)
def test_generate_matches_one_process(ranks, one, cid):
    n, _ = _split(cid)
    got = ranks[cid][0]["generated"].numpy()
    assert got.shape == (CASES[n][1], CASES[n][4])
    np.testing.assert_array_equal(got, _one(one, cid)["generated"])


def test_the_token_gates_have_room(one):
    """No greedy pick is a tie within the reference's logit bound."""
    for key, res in one.items():
        if "picks" in res:
            lg = res["picks"]
            top = torch.topk(lg, 2, dim=-1).values
            gap = float((top[..., 0] - top[..., 1]).min())
            assert gap > REF_TOL * float(lg.abs().max()), key


@pytest.mark.parametrize("cid", DECODE_IDS)
def test_cache_blocks_match_one_process(ranks, one, cid):
    """Every rank's block of every KV cache leaf after the steps: the
    ``cache_shardings`` blocks (batch over "data", KV heads over "model";
    at batch 1 the sequence over "data")."""
    n, mesh = _split(cid)
    v, b = CASES[n][:2]
    want_sh = leaves(steps.cache_shardings(
        build_model(_cfg(v)), MeshShape(("data", "model"), mesh), b, SEQ,
        seq_shard=b == 1))
    want = _one(one, cid)["caches"]
    for r in ranks[cid]:
        assert len(r["caches"]) == len(want) == len(want_sh)
        for (bounds, block, placements), w, sh in zip(r["caches"], want,
                                                      want_sh):
            assert tuple(block.shape) == sh.shard_shape(tuple(w.shape))
            assert placements == str(sh.placements)
            ref = w[tuple(slice(*bd) for bd in bounds)]
            assert float((block - ref).abs().max()) <= \
                TOL * max(float(w.abs().max()), 1.0)


@pytest.mark.parametrize("cid", DECODE_IDS)
def test_serve_layout_gathers_no_parameter(ranks, cid):
    """Weight-stationary: no weight is split over "data", and no decode
    step all-gathers a parameter block: the shard_map path's weights are
    already laid out as its in_specs want them; the spmd path gathers the
    step's tokens over "data" and (EP) the experts' outputs over
    "model", activations.  The shard_map path all-reduces its partial
    output over "model" once a MoE layer (where |model| > 1)."""
    n, (d, m) = _split(cid)
    v = CASES[n][0]
    cfg = _cfg(v)
    r0 = ranks[cid][0]
    blocks_seen = {shape for shape, _, _ in r0["param_layout"]}
    for _, placements, _ in r0["param_layout"]:
        assert placements.startswith("(Replicate()")
    assert not blocks_seen & set(r0["gathers"])
    coll = r0["collectives"]
    assert coll["reduce-scatter"] == 0
    if VARIANTS[v][1] == "shardmap" and m > 1:
        assert coll["all-reduce"] > 0 and coll["count"] >= cfg.n_layers


@pytest.mark.parametrize("n", [n for n in CASES if (2, 2) in CASES[n][-1]])
def test_sharded_decode_matches_the_references(ranks, ref_decode, n):
    """At 2 x 2, against the reference's decode cell jitted with its
    shardings and its decode jitted whole under its mesh: every step's
    logits, every cache block, the generated tokens."""
    r0 = ranks[f"{n}/2x2"][0]
    got = r0["logits"].numpy()
    for tag in ("", "plain_"):
        np.testing.assert_allclose(got, ref_decode[f"{n}__{tag}logits"],
                                   atol=REF_TOL, rtol=REF_TOL)
        for i, (bounds, block, _) in enumerate(r0["caches"]):
            want = ref_decode[f"{n}__{tag}cache{i}"][
                tuple(slice(*b) for b in bounds)]
            np.testing.assert_allclose(block.numpy(), want, atol=REF_TOL,
                                       rtol=REF_TOL)
        np.testing.assert_array_equal(r0["generated"].numpy(),
                                      ref_decode[f"{n}__{tag}generated"])


def test_sequence_sharded_writes_cross_blocks(ranks):
    """mixtral's batch-1 cells: the KV sequence over "data"; their 20
    tokens cross each data rank's block boundary and wrap the window's
    ring, and afterwards every rank's block holds keys."""
    for n in ("mixtral-8x7b-seq", "mixtral-8x7b-shardmap-seq"):
        assert CASES[n][2] > SEQ
        for d, m in CASES[n][-1]:
            for r in ranks[f"{n}/{d}x{m}"]:
                k = [(bd, blk) for bd, blk, _ in r["caches"]
                     if len(bd) == 5 and bd[3][1] - bd[3][0] == SEQ // d]
                assert k and all(float(blk.abs().max()) > 0 for _, blk in k)


@pytest.mark.parametrize("cid", CELL_IDS)
def test_prefill_matches_one_process(ranks, one, cid):
    n, _ = _split(cid)
    got, want = ranks[cid][0]["prefill"], _one(one, cid)["prefill"]
    assert got.shape == want.shape == (B, _cfg(n[5:]).vocab)
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("cid", CELL_IDS)
def test_train_loss_and_every_gradient_leaf_match_one_process(ranks, one,
                                                              cid):
    r0, want = ranks[cid][0], _one(one, cid)
    assert abs(float(r0["loss"]) / float(want["loss"]) - 1) <= TOL
    paths = want["paths"]
    assert len(r0["grads"]) == len(want["grads"]) == len(paths)
    for path, g, w in zip(paths, r0["grads"], want["grads"]):
        assert g.shape == w.shape, path
        assert float(w.abs().max()) > 0, path
        assert _rel(g, w) <= TOL, path


def test_the_train_cells_drop_assignments(one):
    """The capacity matters on these cells: one process's routing drops
    assignments in every variant's train cell, whole and block by
    block."""
    for key, res in one.items():
        if key[0].startswith("cell/"):
            assert res["dropped"] > 0, key


@pytest.mark.parametrize("cid", PLANT_IDS)
def test_the_gradient_test_fails_with_a_planted_fault(ranks, one, cid):
    """The spmd path with its capacity cut to a batch block's (the routing
    still over all T tokens) drops other assignments, and the shard_map
    path with ``Replicate`` for the router's ``Partial`` gradient
    placements takes each rank's share of the router's gradient for the
    whole: either way the gradient test above fails on a leaf, the
    router's among them for the second."""
    n, _ = _split(cid)
    planted = ranks[cid][0]["planted"]
    want = _one(one, cid)
    bad = [p for p, g, w in zip(want["paths"], planted, want["grads"])
           if _rel(g, w) > TOL]
    assert bad
    if VARIANTS[n[5:]][1] == "shardmap":
        assert any(p.endswith("/moe/router") for p in bad), bad


@pytest.mark.parametrize("v", list(VARIANTS))
def test_train_gradients_match_the_reference(ranks, one, ref_train, v):
    """At 2 x 2 against the reference's ``value_and_grad`` of
    ``train_loss`` jitted with ``param_shardings`` under its mesh: every
    gradient leaf; the loss equal for spmd, and for shard_map the port's
    less the aux gap (module docstring)."""
    r0, ref = ranks[f"cell/{v}/2x2"][0], ref_train[v]
    loss, want = float(r0["loss"]), float(ref["loss0"])
    if VARIANTS[v][1] == "shardmap":
        auxes = one[f"cell/{v}", 2]["auxes"]
        gap = 0.01 * sum(np.mean(a) - a[0] for a in auxes)
        print(f"{v}: aux gap {gap:.6e}, {abs(gap / want):.3e} of the "
              f"loss; off by {abs(loss - want):.3e} as it is, "
              f"{abs(loss - gap - want):.3e} less the gap")
        # the gap explains the difference, to far below its own size
        assert abs(loss - gap - want) < 0.01 * abs(gap)
        loss -= gap
    assert abs(loss / want - 1) <= REF_TOL
    for i, g in enumerate(r0["grads"]):
        w = ref[f"g{i}"]
        assert float(np.abs(g.numpy() - w).max()) <= \
            REF_TOL * float(np.abs(w).max())


@pytest.mark.parametrize("cid", CELL_IDS)
def test_shardmap_all_reduces_once_a_layer(ranks, cid):
    """The prefill cell counts one all-reduce of the partial output a
    MoE layer on the shard_map path (``apply_moe_shardmap.all_reduces``),
    none on the spmd path."""
    n, _ = _split(cid)
    cfg = _cfg(n[5:])
    want = cfg.n_layers if cfg.moe_impl == "shardmap" else 0
    assert [r["all_reduces"] for r in ranks[cid]] == [want] * 4


@pytest.mark.parametrize("cid", CELL_IDS)
def test_attention_gets_each_ranks_block(ranks, cid):
    """Every ``flash_attention`` call of the train cell's forward and its
    remat recompute is handed plain local blocks: batch over "data",
    heads over "model" where it divides both head counts (mixtral's
    window band and kimi-k2's full attention)."""
    n, (d, m) = _split(cid)
    cfg = _cfg(n[5:])
    h = (cfg.n_heads // m, cfg.n_kv_heads // m) \
        if cfg.n_kv_heads % m == 0 else (cfg.n_heads, cfg.n_kv_heads)
    want = ((B // d, h[0], S, cfg.hd), (B // d, h[1], S, cfg.hd), "Tensor")
    for r in ranks[cid]:
        assert r["blocks"] == [want] * (2 * cfg.n_layers)


@pytest.mark.parametrize("seed", range(6))
def test_moe_route_counts_equal_bincount(seed):
    """``moe_route``'s counts (a scatter-add of ones) equal ``bincount``'s
    bit for bit, values and dtypes: the aux's expert fractions and the
    slots, over seeded draws of tokens and routers, EP ranks' windows
    included."""
    g = torch.Generator().manual_seed(seed)
    cfg = _cfg("kimi-k2" if seed % 2 else "mixtral-8x7b")
    e, k = cfg.n_experts, cfg.top_k
    t = 5 + 7 * seed
    h = torch.randn(t, cfg.d_model, generator=g)
    router = torch.randn(cfg.d_model, e, generator=g) * (0.05 + 0.1 * seed)
    lo, n_local = (e // 4 * (seed % 4), e // 4) if seed % 2 else (0, e)
    r = blocks.moe_route(cfg, router, h, lo, n_local)
    frac = torch.bincount(r.idx.reshape(-1), minlength=e).float() / (t * k)
    aux = e * torch.sum(frac * torch.softmax((h @ router).float(),
                                             -1).mean(0))
    assert torch.equal(r.aux, aux)
    counts = torch.bincount(r.sorted_e, minlength=n_local + 1)
    got = blocks._count(r.sorted_e, n_local + 1, torch.int64)
    assert got.dtype == counts.dtype and torch.equal(got, counts)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(t * k) - starts[r.sorted_e]
    assert torch.equal(r.pos, torch.where(
        (rank < r.capacity) & (r.sorted_e < n_local), rank,
        torch.full_like(rank, r.capacity)))


def test_moe_route_runs_under_fake_tensor_mode():
    """On fake tensors (the dry run's) the routing and the whole MoE block
    run and give the shapes and dtypes of real tensors; ``bincount``
    would refuse them (its length depends on the data)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = _cfg("kimi-k2")
    model = build_model(cfg)
    moe = model.init(0, device="cpu")["units"][0]["moe"]
    p0 = {k: (v[0] if k != "norm" else {"scale": v["scale"][0]})
          for k, v in moe.items()}
    x = torch.randn(2, 6, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    y, aux = blocks.apply_moe(cfg, p0, x)
    r = blocks.moe_route(cfg, p0["router"], x.reshape(-1, cfg.d_model))
    with FakeTensorMode() as mode:
        fx = mode.from_tensor(x)
        fp = {k: (mode.from_tensor(v) if k != "norm"
                  else {"scale": mode.from_tensor(v["scale"])})
              for k, v in p0.items()}
        fr = blocks.moe_route(cfg, fp["router"], fx.reshape(-1, cfg.d_model))
        fy, faux = blocks.apply_moe(cfg, fp, fx)
        with pytest.raises(Exception):
            torch.bincount(fr.sorted_e)
    for got, want in ((fy, y), (faux, aux), (fr.pos, r.pos),
                      (fr.gate_w, r.gate_w), (fr.aux, r.aux)):
        assert tuple(got.shape) == tuple(want.shape)
        assert got.dtype == want.dtype
    assert fr.capacity == r.capacity
