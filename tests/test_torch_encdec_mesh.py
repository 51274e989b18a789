"""The encoder-decoder on a mesh: ``launch/steps.place_cell`` places the
decode, prefill and train cells of the whisper-large-v3 smoke config on a
(data, model) mesh of gloo ranks as DTensors, by ``build_cell``'s
shardings, and ``models/whisper.EncDec``'s steps run on them unchanged:
the encoder, the decoder's self-attention and its cross-attention run
``flash_attention`` on each rank's block of batch and heads
(``blocks._attention``), the decode step writes and attends its own
self-attention cache blocks and reads its block of the ``cross`` caches
(``cache_shardings``' ``k``/``v`` layout), and ``DecodeEngine.generate``
runs on the placed parameters.

The port's side runs on 4 spawned ranks (``tests/torch_ranks.py``, rank
body ``tests/torch_mesh_ranks.cells_mesh_rank``), one group for the
meshes (2, 2), (4, 1) and (1, 4); no process group runs in the pytest
worker.  The reference's side runs in fresh subprocesses with 4 XLA host
devices: its decode cell (``tests/torch_decode_mesh_ref.py``) and its
train gradients (``tests/torch_train_mesh_ref.py``) jitted with their
shardings on its own 2 x 2 mesh.

Weights: the reference's ``init`` perturbed with numpy noise, carried
over by ``models/convert.params_from_reference``; tokens, frames and the
decode's cross caches: numpy draws from a seed.  Decode: batch 4 with 16
self-attention slots and the encoder's 64 frames; the teacher-forced
steps read cross caches drawn from a seed, the generation zero ones (the
reference's engine leaves them zero).

Tolerances (float32), PR 29's:
- against the port's one process: every decode step's logits, the
  prefill's and the train loss within 1e-5 of their max |value|, every
  cache block and every gradient leaf within 1e-5 of the leaf's max (the
  head blocks' output projections sum over "model" in other orders);
- against the reference's sharded cells: 1e-4, absolute and relative for
  the decode, of a leaf's max for the gradients; generated tokens equal.
"""

import collections
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
from repro_torch.parallel.sharding import MeshShape
from repro_torch.serve.engine import DecodeEngine, ServeConfig
from repro_torch.tree import leaves

import torch_mesh_ranks
import torch_ranks
from torch_threads import one_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF_TIMEOUT = 300
# the group runs every case in about 40 s beside the references'
# subprocesses; the limit only stops a hung collective
RANK_TIMEOUT = 300
ARCH = "whisper-large-v3"
CFG = SMOKE[ARCH]
MESHES = [(2, 2), (4, 1), (1, 4)]
SEQ = 16
BATCH, STEPS, LENGTHS, GEN = 4, 10, (6, 4, 5, 6), 4
B, S = 4, 24              # the train and prefill cells' tokens
COUNT_AT = 2
TOL = 1e-5
REF_TOL = 1e-4
DECODE_IDS = [f"{ARCH}/{d}x{m}" for d, m in MESHES]
CELL_IDS = [f"cell/{ARCH}/{d}x{m}" for d, m in MESHES]


def _paths(tree, prefix=""):
    """Each leaf's path, in ``leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _paths(tree[k], f"{prefix}/{k}")]
    return [prefix]


@pytest.fixture(scope="module")
def weights():
    """(reference leaves as numpy, the port's tree)."""
    ref = ref_build_model(REF_SMOKE[ARCH])
    rng = np.random.default_rng(0)
    tree = jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32),
        ref.init(jax.random.PRNGKey(0))[0])
    return (jax.tree.leaves(tree),
            params_from_reference(CFG, tree, device="cpu"))


@pytest.fixture(scope="module")
def case():
    """The decode's tokens [BATCH, STEPS], prompts and cross caches; the
    cells' tokens [B, S] and frames [B, Se, d]."""
    rng = np.random.default_rng(1)
    tokens = rng.integers(1, CFG.vocab, (BATCH, STEPS)).astype(np.int32)
    prompts = [rng.integers(1, CFG.vocab, n).astype(np.int32).tolist()
               for n in LENGTHS]
    kv = (CFG.n_layers, BATCH, CFG.n_kv_heads, CFG.enc_seq, CFG.hd)
    cross = {k: rng.standard_normal(kv).astype(np.float32)
             for k in ("k", "v")}
    rng = np.random.default_rng(3)
    cells = {"tokens": rng.integers(1, CFG.vocab, (B, S)).astype(np.int32),
             "frames": rng.standard_normal(
                 (B, CFG.enc_seq, CFG.d_model)).astype(np.float32)}
    return tokens, prompts, cross, cells


def _popen(script, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / script), *map(str, args)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


@pytest.fixture(scope="module")
def ref(weights, case, tmp_path_factory):
    """The reference's sharded decode cell and train gradients on its 2 x
    2 mesh, started first so they run beside the port's ranks."""
    tokens, prompts, cross, cells = case
    d = tmp_path_factory.mktemp("encdec_mesh_ref")
    plen = max(LENGTHS)
    padded = np.zeros((BATCH, plen), np.int32)
    for i, p in enumerate(prompts):
        padded[i, plen - len(p):] = p
    n = ARCH
    np.savez(d / "decode.npz", names=json.dumps([n]),
             **{f"{n}__arch": ARCH, f"{n}__seq": SEQ, f"{n}__tokens": tokens,
                f"{n}__gen": GEN, f"{n}__prompts": padded,
                f"{n}__cross_k": cross["k"], f"{n}__cross_v": cross["v"]},
             **{f"{n}__p{i}": a for i, a in enumerate(weights[0])})
    np.savez(d / "train.npz", arch=ARCH, grads_only=True,
             tokens=cells["tokens"][None], frames=cells["frames"][None],
             opt=json.dumps(dict(lr=1e-5, warmup_steps=1, total_steps=10)),
             **{f"p{i}": a for i, a in enumerate(weights[0])})
    procs = {tag: (_popen(script, d / f"{tag}.npz", d / f"{tag}_out.npz"),
                   d / f"{tag}_out.npz")
             for tag, script in (("decode", "torch_decode_mesh_ref.py"),
                                 ("train", "torch_train_mesh_ref.py"))}
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
    return _ref_out(ref, "train")


def _torch(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def ranks(weights, case, ref, tmp_path_factory):
    """{case/mesh or cell/case/mesh: [each rank's result]} from one
    spawned group of 4."""
    tokens, prompts, cross, cells = case
    d = tmp_path_factory.mktemp("encdec_mesh_ranks")
    cfg = dataclasses.asdict(CFG)
    dec = {ARCH: {"cfg": cfg, "params": weights[1], "seq": SEQ,
                  "tokens": torch.from_numpy(tokens), "prompts": prompts,
                  "gen": GEN, "meshes": MESHES, "count_at": COUNT_AT,
                  "cross": _torch(cross)}}
    cell = {ARCH: {"cfg": cfg, "params": weights[1], "batch": _torch(cells),
                   "meshes": MESHES}}
    torch.save({"decode": dec, "cells": cell}, d / "case.pt")
    res = torch_ranks.run_ranks(torch_mesh_ranks.cells_mesh_rank, 4,
                                d / "work", str(d / "case.pt"),
                                timeout=RANK_TIMEOUT)
    return {k: [r[k] for r in res] for k in res[0]}


@pytest.fixture(scope="module")
def one(weights, case):
    """The port's one-process runs: the decode's steps (from the drawn
    cross caches), caches and generation; the train loss, gradients and
    prefill."""
    tokens, prompts, cross, cells = case
    params = weights[1]
    model = build_model(CFG)
    caches = model.init_cache(BATCH, SEQ, torch.float32, device="cpu")
    caches["cross"] = _torch(cross)
    logits = []
    for t in range(STEPS):
        lg, caches = model.decode_step(params, caches,
                                       torch.from_numpy(tokens[:, t:t + 1]))
        logits.append(lg)
    engine = DecodeEngine(model, params, ServeConfig(max_seq=SEQ,
                                                     batch=BATCH),
                          device="cpu")
    seen = []
    step = model.decode_step

    def recorded(*args):
        lg, c = step(*args)
        seen.append(lg)
        return lg, c

    model.decode_step = recorded
    generated = engine.generate(prompts, GEN)
    plen = max(LENGTHS)
    batch = _torch(cells)
    loss, grads = steps._value_and_grad(build_model(CFG), params, batch,
                                        True)
    with torch.no_grad():
        prefill = steps.make_prefill(build_model(CFG))(params, batch)
    return {"logits": torch.stack(logits), "caches": leaves(caches),
            "generated": generated,
            "picks": torch.stack(seen[plen - 1:plen - 1 + GEN]),
            "loss": loss, "grads": grads, "prefill": prefill,
            "paths": _paths(params)}


def _mesh(cid):
    return tuple(map(int, cid.rsplit("/", 1)[1].split("x")))


def _rel(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                   1e-30)


@pytest.mark.parametrize("cid", DECODE_IDS + CELL_IDS)
def test_ranks_cover_the_mesh_and_agree(ranks, cid):
    d, m = _mesh(cid)
    got = ranks[cid]
    assert sorted(r["coord"] for r in got) == [
        (i, j) for i in range(d) for j in range(m)]
    for key in ("logits", "generated", "loss", "prefill"):
        if key in got[0]:
            for r in got[1:]:
                assert torch.equal(r[key], got[0][key]), key


@pytest.mark.parametrize("cid", DECODE_IDS)
def test_decode_steps_match_one_process(ranks, one, cid):
    got, want = ranks[cid][0]["logits"], one["logits"]
    assert got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    for g, w in zip(got, want):
        assert _rel(g, w) <= TOL


@pytest.mark.parametrize("cid", DECODE_IDS)
def test_generate_matches_one_process(ranks, one, cid):
    got = ranks[cid][0]["generated"].numpy()
    assert got.shape == (BATCH, GEN)
    np.testing.assert_array_equal(got, one["generated"])


def test_the_token_gates_have_room(one):
    """No greedy pick is a tie within the reference's logit bound."""
    lg = one["picks"]
    top = torch.topk(lg, 2, dim=-1).values
    gap = float((top[..., 0] - top[..., 1]).min())
    assert gap > REF_TOL * float(lg.abs().max())


@pytest.mark.parametrize("cid", DECODE_IDS)
def test_cache_blocks_match_one_process(ranks, one, cid):
    """Every rank's block of the self-attention caches after the steps
    and of the cross caches it read: the ``cache_shardings`` blocks
    (batch over "data", KV heads over "model")."""
    want_sh = leaves(steps.cache_shardings(
        build_model(CFG), MeshShape(("data", "model"), _mesh(cid)), BATCH,
        SEQ, seq_shard=False))
    want = one["caches"]
    for r in ranks[cid]:
        assert len(r["caches"]) == len(want) == len(want_sh) == 5
        for (bounds, block, placements), w, sh in zip(r["caches"], want,
                                                      want_sh):
            assert tuple(block.shape) == sh.shard_shape(tuple(w.shape))
            assert placements == str(sh.placements)
            ref = w[tuple(slice(*bd) for bd in bounds)]
            assert float((block - ref).abs().max()) <= \
                TOL * max(float(w.abs().max()), 1.0)


@pytest.mark.parametrize("cid", DECODE_IDS)
def test_serve_layout_gathers_nothing(ranks, cid):
    """Weight-stationary: no weight is split over "data", and a decode
    step all-gathers nothing (heads split on both counts or neither, the
    embedding's vocab blocks added by an all-reduce); no reduce-scatter
    (no gradient)."""
    d, m = _mesh(cid)
    r0 = ranks[cid][0]
    for _, placements, _ in r0["param_layout"]:
        assert placements.startswith("(Replicate()")
    assert r0["gathers"] == []
    coll = r0["collectives"]
    assert coll["reduce-scatter"] == 0 and coll["all-gather"] == 0
    assert (coll["count"] > 0) == (m > 1)


def test_sharded_decode_matches_the_references(ranks, ref_decode):
    """At 2 x 2, against the reference's decode cell jitted with its
    shardings and its decode jitted whole: every step's logits (from the
    drawn cross caches), every cache block, the generated tokens."""
    n = ARCH
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


@pytest.mark.parametrize("cid", CELL_IDS)
def test_prefill_matches_one_process(ranks, one, cid):
    got, want = ranks[cid][0]["prefill"], one["prefill"]
    assert got.shape == want.shape == (B, CFG.vocab)
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("cid", CELL_IDS)
def test_train_loss_and_every_gradient_leaf_match_one_process(ranks, one,
                                                              cid):
    r0 = ranks[cid][0]
    assert abs(float(r0["loss"]) / float(one["loss"]) - 1) <= TOL
    paths = one["paths"]
    assert len(r0["grads"]) == len(one["grads"]) == len(paths)
    for path, g, w in zip(paths, r0["grads"], one["grads"]):
        assert g.shape == w.shape, path
        assert float(w.abs().max()) > 0, path
        assert _rel(g, w) <= TOL, path


def test_train_gradients_match_the_reference(ranks, ref_train):
    """At 2 x 2 against the reference's ``value_and_grad`` of
    ``train_loss`` jitted with ``param_shardings``."""
    r0 = ranks[f"cell/{ARCH}/2x2"][0]
    assert abs(float(r0["loss"]) / float(ref_train["loss0"]) - 1) <= REF_TOL
    for i, g in enumerate(r0["grads"]):
        w = ref_train[f"g{i}"]
        assert float(np.abs(g.numpy() - w).max()) <= \
            REF_TOL * float(np.abs(w).max())


@pytest.mark.parametrize("cid", CELL_IDS)
def test_attention_gets_each_ranks_block(ranks, cid):
    """Every ``flash_attention`` call of the train cell's forward and its
    remat recompute is handed plain local blocks, batch over "data" and
    heads over "model": the encoder's (frames against frames), the
    decoder's self-attention (tokens against tokens) and its
    cross-attention (tokens against frames), each layer twice."""
    d, m = _mesh(cid)
    h, hd, se = CFG.n_heads // m, CFG.hd, CFG.enc_seq

    def call(sq, sk):
        return ((B // d, h, sq, hd), (B // d, h, sk, hd), "Tensor")

    want = collections.Counter({call(se, se): 2 * CFG.n_enc_layers,
                                call(S, S): 2 * CFG.n_layers,
                                call(S, se): 2 * CFG.n_layers})
    for r in ranks[cid]:
        assert collections.Counter(r["blocks"]) == want


def test_decode_step_runs_under_fake_tensor_mode():
    """``decode_step`` reads the position row at the cache length by a
    one-element index: on fake tensors (the dry run's) it runs and gives
    the shapes of real tensors; its values are the row's (the reference's
    decode, ``tests/test_torch_whisper.py``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    model = build_model(CFG)
    params = model.init(0, device="cpu")
    caches = model.init_cache(2, SEQ, torch.float32, device="cpu")
    tokens = torch.ones((2, 1), dtype=torch.int32)
    lg, _ = model.decode_step(params, caches, tokens)
    with FakeTensorMode(allow_non_fake_inputs=True):
        fp = {k: v for k, v in params.items()}
        fake_caches = model.init_cache(2, SEQ, torch.float32, device="cpu")
        flg, fc = model.decode_step(fp, fake_caches, torch.ones(
            (2, 1), dtype=torch.int32))
    assert tuple(flg.shape) == tuple(lg.shape) and flg.dtype == lg.dtype
    assert tuple(fc["self"]["k"].shape) == tuple(caches["self"]["k"].shape)
