"""The recurrent families on a mesh: ``launch/steps.place_cell`` places
the decode, prefill and train cells of the rwkv6-7b (SSM) and zamba2-7b
(hybrid) smoke configs on a (data, model) mesh of gloo ranks as DTensors,
by ``build_cell``'s shardings, and the steps run on them unchanged: the
WKV and SSD kernels on each rank's block of batch and heads
(``models/blocks._on_blocks``), the WKV and SSM states by (batch, heads),
the conv and token-shift states by batch; ``DecodeEngine.generate`` runs
on the placed parameters.

The port's side runs on 4 spawned ranks (``tests/torch_ranks.py``, rank
body ``tests/torch_mesh_ranks.recurrent_mesh_rank``), one group for the
meshes (2, 2), (4, 1) and (1, 4); no process group runs in the pytest
worker.  The reference's side runs in fresh subprocesses with 4 XLA host
devices: its decode cells (``tests/torch_decode_mesh_ref.py``) and its
train gradients (``tests/torch_train_mesh_ref.py``) jitted with their
shardings on its own 2 x 2 mesh.

Weights: the reference's ``init`` perturbed with numpy noise, carried
over by ``models/convert.params_from_reference``; tokens: numpy draws
from a seed.  Decode: batch 4 with 16 cache slots; zamba2's batch-1 case
(``zamba2-7b-seq``: ``long_500k``'s layout, the shared block's KV
sequence over "data", 8 or 4 slots a data rank) takes 20 tokens, so its
writes cross blocks and the shared block's slot clamps.

Tolerances (float32):
- against the port's one process: every decode step's logits, the
  prefill's and the train loss within 1e-5 of their max |value|, every
  state block and every gradient leaf within 1e-5 of the leaf's max
  (the blocks' products and the norms over "model" sum in other orders:
  up to 3.5e-6 measured, rwkv6's gradients at (1, 4); with ``Replicate``
  planted for the ``Partial`` gradient placements, 1.0 or more);
- against the reference's sharded cells: ``tests/test_torch_dense.py``'s
  1e-4, absolute and relative for the decode, of a leaf's max for the
  gradients (up to 5.6e-6 measured); generated tokens equal.
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
from repro_torch.kernels.mamba2_ssd import ops as ssd_ops
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.launch import steps
from repro_torch.models.convert import params_from_reference
from repro_torch.models.registry import build_model
from repro_torch.parallel.sharding import MeshShape
from repro_torch.serve.engine import DecodeEngine, ServeConfig
from repro_torch.tree import leaves

import torch_mesh_ranks
import torch_ranks
from torch_threads import one_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF_TIMEOUT = 300
# the group runs every case in about 60 s beside the references'
# subprocesses; the limit only stops a hung collective
RANK_TIMEOUT = 300
ARCHS = ("rwkv6-7b", "zamba2-7b")
MESHES = [(2, 2), (4, 1), (1, 4)]
PLANT = [(2, 2), (4, 1)]
SEQ = 16
# name -> (arch, batch, teacher-forced tokens, prompt lengths, generated,
# meshes)
CASES = {
    "rwkv6-7b": ("rwkv6-7b", 4, 10, (6, 4, 5, 6), 4, MESHES),
    "zamba2-7b": ("zamba2-7b", 4, 10, (6, 4, 5, 6), 4, MESHES),
    "zamba2-7b-seq": ("zamba2-7b", 1, 20, (12,), 8, [(2, 2), (4, 1)]),
}
B, S = 4, 24              # the train and prefill cells' tokens
COUNT_AT = 2
TOL = 1e-5
REF_TOL = 1e-4
# the leaves the gradient test names: each is replicated over a mesh dim
# that splits the work, or takes its gradient through one that is
NAMED = ("bonus", "A_log", "dt_bias", "conv_w", "w_in")
DECODE_IDS = [f"{c}/{d}x{m}" for c, spec in CASES.items()
              for d, m in spec[-1]]
CELL_IDS = [f"cell/{a}/{d}x{m}" for a in ARCHS for d, m in MESHES]


def _prompts(arch, b, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, SMOKE[arch].vocab, n).astype(np.int32).tolist()
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


@pytest.fixture(scope="module")
def weights():
    return {arch: _perturbed(arch) for arch in ARCHS}


@pytest.fixture(scope="module")
def case(weights):
    """{decode case: (tokens, prompts)}, {arch: train tokens [B, S]}."""
    decode = {}
    for n, (arch, b, t, lengths, _, _) in CASES.items():
        tokens = np.random.default_rng(1).integers(
            1, SMOKE[arch].vocab, (b, t)).astype(np.int32)
        decode[n] = (tokens, _prompts(arch, b, lengths, 2))
    cells = {arch: np.random.default_rng(3).integers(
        1, SMOKE[arch].vocab, (B, S)).astype(np.int32) for arch in ARCHS}
    return decode, cells


def _popen(script, d, *args):
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
    d = tmp_path_factory.mktemp("recurrent_mesh_ref")
    arrays = {"names": json.dumps(list(CASES))}
    for n, (tokens, prompts) in decode.items():
        arch = CASES[n][0]
        arrays.update({f"{n}__arch": arch, f"{n}__seq": SEQ,
                       f"{n}__tokens": tokens, f"{n}__gen": CASES[n][4],
                       f"{n}__prompts": _left_padded(prompts)})
        arrays.update({f"{n}__p{i}": a
                       for i, a in enumerate(weights[arch][0])})
    np.savez(d / "decode.npz", **arrays)
    procs = {"decode": (_popen("torch_decode_mesh_ref.py", d, d / "decode.npz",
                               d / "decode_out.npz"), d / "decode_out.npz")}
    for arch in ARCHS:
        np.savez(d / f"{arch}.npz", arch=arch, tokens=cells[arch][None],
                 opt=json.dumps(dict(lr=1e-5, warmup_steps=1,
                                     total_steps=10)),
                 **{f"p{i}": a for i, a in enumerate(weights[arch][0])})
        procs[arch] = (_popen("torch_train_mesh_ref.py", d, d / f"{arch}.npz",
                              d / f"{arch}_out.npz"), d / f"{arch}_out.npz")
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
    return {arch: _ref_out(ref, arch) for arch in ARCHS}


@pytest.fixture(scope="module")
def ranks(weights, case, ref, tmp_path_factory):
    """{case/mesh or arch/mesh: [each rank's result]} from one spawned
    group of 4."""
    decode, cells = case
    d = tmp_path_factory.mktemp("recurrent_mesh_ranks")
    dec = {}
    for n, (tokens, prompts) in decode.items():
        arch, _, _, _, gen, meshes = CASES[n]
        dec[n] = {"cfg": dataclasses.asdict(SMOKE[arch]),
                  "params": weights[arch][1], "seq": SEQ,
                  "tokens": torch.from_numpy(tokens), "prompts": prompts,
                  "gen": gen, "meshes": meshes, "count_at": COUNT_AT}
    cell = {arch: {"cfg": dataclasses.asdict(SMOKE[arch]),
                   "params": weights[arch][1],
                   "tokens": torch.from_numpy(cells[arch]),
                   "meshes": MESHES} for arch in ARCHS}
    torch.save({"decode": dec, "cells": cell, "plant": PLANT},
               d / "case.pt")
    res = torch_ranks.run_ranks(torch_mesh_ranks.recurrent_mesh_rank, 4,
                                d / "work", str(d / "case.pt"),
                                timeout=RANK_TIMEOUT)
    return {k: [r[k] for r in res] for k in res[0]}


@pytest.fixture(scope="module")
def one(weights, case):
    """The port's one-process runs: each decode case's steps, caches and
    generation; each arch's train loss, gradients and prefill."""
    decode, cells = case
    out = {}
    for n, (tokens, prompts) in decode.items():
        arch, b, _, _, gen, _ = CASES[n]
        params = weights[arch][1]
        model = build_model(SMOKE[arch])
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
        out[n] = {"logits": torch.stack(logits), "caches": leaves(caches),
                  "generated": generated,
                  "picks": torch.stack(seen[plen - 1:plen - 1 + gen])}
    for arch in ARCHS:
        params = weights[arch][1]
        model = build_model(SMOKE[arch])
        batch = {"tokens": torch.from_numpy(cells[arch])}
        loss, grads = steps._value_and_grad(model, params, batch, True)
        with torch.no_grad():
            prefill = steps.make_prefill(model)(params, batch)
        out[f"cell/{arch}"] = {"loss": loss, "grads": grads,
                               "prefill": prefill, "paths": _paths(params)}
    return out


def _split(cid):
    """(decode case or ``cell/<arch>``, mesh) of a result's id."""
    n, mesh = cid.rsplit("/", 1)
    return n, tuple(map(int, mesh.split("x")))


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
    n, _ = _split(cid)
    got, want = ranks[cid][0]["logits"], one[n]["logits"]
    assert got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    for g, w in zip(got, want):
        assert _rel(g, w) <= TOL


@pytest.mark.parametrize("cid", DECODE_IDS)
def test_generate_matches_one_process(ranks, one, cid):
    n, _ = _split(cid)
    got = ranks[cid][0]["generated"].numpy()
    assert got.shape == (CASES[n][1], CASES[n][4])
    np.testing.assert_array_equal(got, one[n]["generated"])


def test_the_token_gates_have_room(one):
    """No greedy pick is a tie within the reference's logit bound."""
    for n in CASES:
        lg = one[n]["picks"]
        top = torch.topk(lg, 2, dim=-1).values
        gap = float((top[..., 0] - top[..., 1]).min())
        assert gap > REF_TOL * float(lg.abs().max()), n


@pytest.mark.parametrize("cid", DECODE_IDS)
def test_state_blocks_match_one_process(ranks, one, cid):
    """Every rank's block of every state leaf after the steps: the WKV
    and SSM states by (batch, heads), the conv and token-shift states by
    batch, zamba2's shared block's KV caches as the dense family's; each
    rank's blocks are the ``cache_shardings`` blocks."""
    n, mesh = _split(cid)
    arch, b = CASES[n][:2]
    model = build_model(SMOKE[arch])
    want_sh = leaves(steps.cache_shardings(
        model, MeshShape(("data", "model"), mesh), b, SEQ,
        seq_shard=b == 1))
    want = one[n]["caches"]
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
    """Weight-stationary: no weight is split over "data", and a decode
    step all-gathers activations only: zamba2's in-projection over
    "model" (one token's [B/d, 1, cols/m] a Mamba2 layer; its columns'
    pieces do not fall on an even cut), nothing in rwkv6's step."""
    n, (d, m) = _split(cid)
    arch, b = CASES[n][:2]
    cfg = SMOKE[arch]
    r0 = ranks[cid][0]
    blocks_seen = {shape for shape, _, _ in r0["param_layout"]}
    for _, placements, _ in r0["param_layout"]:
        assert placements.startswith("(Replicate()")
    assert not blocks_seen & set(r0["gathers"])
    coll = r0["collectives"]
    assert coll["reduce-scatter"] == 0
    if cfg.family == "ssm" or m == 1:
        assert r0["gathers"] == []
    else:
        cols = 2 * cfg.ssm_heads * cfg.ssm_head_dim + \
            2 * cfg.ssm_groups * cfg.ssm_state + cfg.ssm_heads
        bd = b // d if b % d == 0 else b
        assert r0["gathers"] == [(bd, 1, cols // m)] * cfg.n_layers
    assert (coll["count"] > 0) == (m > 1 or (b == 1 and d > 1))


@pytest.mark.parametrize("n", list(CASES))
def test_sharded_decode_matches_the_references(ranks, ref_decode, n):
    """At 2 x 2, against the reference's decode cell jitted with its
    shardings and its unsharded decode: every step's logits, every state
    block, the generated tokens (while no cache is full: every step of
    the batch-4 cases, zamba2-7b-seq's first 16 against the sharded
    cell, whose partitioned write drops once the shared block's cache is
    full, as ``tests/test_torch_decode_mesh.py`` pins)."""
    r0 = ranks[f"{n}/2x2"][0]
    got = r0["logits"].numpy()
    full = min(got.shape[0], SEQ)
    np.testing.assert_allclose(got[:full], ref_decode[f"{n}__logits"][:full],
                               atol=REF_TOL, rtol=REF_TOL)
    np.testing.assert_allclose(got, ref_decode[f"{n}__plain_logits"],
                               atol=REF_TOL, rtol=REF_TOL)
    for i, (bounds, block, _) in enumerate(r0["caches"]):
        want = ref_decode[f"{n}__plain_cache{i}"][
            tuple(slice(*b) for b in bounds)]
        np.testing.assert_allclose(block.numpy(), want, atol=REF_TOL,
                                   rtol=REF_TOL)
        if CASES[n][2] <= SEQ:
            np.testing.assert_allclose(
                block.numpy(), ref_decode[f"{n}__cache{i}"][
                    tuple(slice(*b) for b in bounds)],
                atol=REF_TOL, rtol=REF_TOL)
    gen = r0["generated"].numpy()
    np.testing.assert_array_equal(gen, ref_decode[f"{n}__plain_generated"])
    if max(CASES[n][3]) + CASES[n][4] <= SEQ:
        np.testing.assert_array_equal(gen, ref_decode[f"{n}__generated"])


def test_sequence_sharded_writes_cross_blocks(ranks):
    """zamba2's batch-1 cell: the shared block's KV sequence over "data";
    its 20 tokens cross each data rank's block boundary, and afterwards
    every rank's block holds keys."""
    n = "zamba2-7b-seq"
    assert CASES[n][2] > SEQ
    for d, m in CASES[n][-1]:
        for r in ranks[f"{n}/{d}x{m}"]:
            k = [(bd, blk) for bd, blk, _ in r["caches"]
                 if len(bd) == 5 and bd[3][1] - bd[3][0] == SEQ // d]
            assert k and all(float(blk.abs().max()) > 0 for _, blk in k)


@pytest.mark.parametrize("cid", CELL_IDS)
def test_prefill_matches_one_process(ranks, one, cid):
    n, _ = _split(cid)
    got, want = ranks[cid][0]["prefill"], one[n]["prefill"]
    assert got.shape == want.shape == (B, SMOKE[n[5:]].vocab)
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("cid", CELL_IDS)
def test_train_loss_and_every_gradient_leaf_match_one_process(ranks, one,
                                                              cid):
    n, _ = _split(cid)
    r0 = ranks[cid][0]
    assert abs(float(r0["loss"]) / float(one[n]["loss"]) - 1) <= TOL
    paths, want = one[n]["paths"], one[n]["grads"]
    assert len(r0["grads"]) == len(want) == len(paths)
    named = set()
    for path, g, w in zip(paths, r0["grads"], want):
        assert g.shape == w.shape, path
        assert float(w.abs().max()) > 0, path
        assert _rel(g, w) <= TOL, path
        named |= {n for n in NAMED if path.endswith("/" + n)}
    fam = {"rwkv6-7b": {"bonus"},
           "zamba2-7b": {"A_log", "dt_bias", "conv_w", "w_in"}}[n[5:]]
    assert named == fam


@pytest.mark.parametrize("cid", [f"cell/{a}/{d}x{m}" for a in ARCHS
                                 for d, m in PLANT])
def test_the_gradient_test_fails_with_replicate_planted(ranks, one, cid):
    """``Replicate`` planted in place of ``_on_blocks``' ``Partial``
    gradient placements: each rank's share of the bonus's or the decay
    rates' gradient (summed over its batch block only) passes for the
    whole, and the gradient test above fails on a named leaf."""
    n, _ = _split(cid)
    planted = ranks[cid][0]["planted"]
    paths, want = one[n]["paths"], one[n]["grads"]
    bad = [p for p, g, w in zip(paths, planted, want) if _rel(g, w) > TOL]
    assert any(p.endswith("/" + n) for p in bad for n in NAMED), bad


@pytest.mark.parametrize("arch", ARCHS)
def test_train_gradients_match_the_reference(ranks, ref_train, arch):
    """At 2 x 2 against the reference's ``value_and_grad`` of
    ``train_loss`` jitted with ``param_shardings``."""
    r0, ref = ranks[f"cell/{arch}/2x2"][0], ref_train[arch]
    assert abs(float(r0["loss"]) / float(ref["loss0"]) - 1) <= REF_TOL
    for i, g in enumerate(r0["grads"]):
        w = ref[f"g{i}"]
        assert float(np.abs(g.numpy() - w).max()) <= \
            REF_TOL * float(np.abs(w).max())


@pytest.mark.parametrize("cid", CELL_IDS)
def test_kernels_get_each_ranks_block(ranks, cid):
    """Every call of the WKV or SSD kernel in the train cell's forward and
    its remat recompute is handed plain local blocks: batch over "data",
    heads over "model" (rwkv6's [B/d, H/m, S, K], zamba2's [B/d, S, H/m,
    P])."""
    n, (d, m) = _split(cid)
    cfg = SMOKE[n[5:]]
    model = build_model(cfg)
    if cfg.family == "ssm":
        want = ("wkv6", (B // d, cfg.d_model // cfg.rwkv_head_dim // m, S,
                         cfg.rwkv_head_dim), "Tensor")
    else:
        want = ("ssd", (B // d, S, cfg.ssm_heads // m, cfg.ssm_head_dim),
                "Tensor")
    # the repeats' layers run again in the remat recompute, the tail's not
    calls = 2 * model.repeats * len(model.unit) + len(model.tail)
    for r in ranks[cid]:
        assert r["blocks"] == [want] * calls


@pytest.mark.parametrize("name", ["wkv6", "ssd"])
def test_shape_only_path_on_fake_tensors(name, monkeypatch):
    """On fake tensors (the dry run's) ``wkv6`` and ``ssd`` and their
    gradients run no scan and give the plain versions' shapes and
    dtypes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    g = torch.Generator().manual_seed(0)
    if name == "wkv6":
        mod, plain, fn = wkv_ops, "wkv6_plain", wkv_ops.wkv6
        args = [torch.rand(2, 3, 5, 4, generator=g) for _ in range(3)] + [
            torch.rand(2, 3, 5, 4, generator=g), torch.rand(3, 4,
                                                            generator=g)]
        args[2] = torch.rand(2, 3, 5, 6, generator=g)
    else:
        mod, plain, fn = ssd_ops, "ssd_plain", ssd_ops.ssd
        args = [torch.rand(2, 5, 4, 3, generator=g),
                torch.rand(2, 5, 4, generator=g), -torch.rand(4, generator=g),
                torch.rand(2, 5, 2, 6, generator=g),
                torch.rand(2, 5, 2, 6, generator=g)]
    want = fn(*args)

    def refuse(*a, **kw):
        raise AssertionError("a scan ran on fake tensors")

    monkeypatch.setattr(mod, plain, refuse)
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(a).requires_grad_(True) for a in args]
        out = fn(*fake)
        grads = torch.autograd.grad(out.sum(), fake)
    assert tuple(out.shape) == tuple(want.shape)
    assert out.dtype == want.dtype
    assert [tuple(x.shape) for x in grads] == [tuple(a.shape) for a in args]
