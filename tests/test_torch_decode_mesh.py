"""The sharded decode cell: ``launch/steps.place_cell`` places a decode
cell of the qwen1.5-4b, gemma3-12b and qwen2-vl-72b smoke configs on a
(data, model) mesh of gloo ranks as DTensors, by ``build_cell``'s
shardings (the serve layout, weight-stationary: heads, mlp and vocab over
"model", no weight over "data"; the caches by ``cache_shardings``: batch
over "data", KV heads over "model", and at batch 1 the KV sequence over
"data"), and ``make_decode_step`` runs on it unchanged, each rank writing
and attending its own cache blocks; ``DecodeEngine.generate`` runs on the
placed parameters.

The port's side runs on 4 spawned ranks (``tests/torch_ranks.py``, rank
body ``tests/torch_mesh_ranks.decode_mesh_rank``), one group for the
meshes (2, 2), (4, 1) and (1, 4); no process group runs in the pytest
worker.  The reference's side runs in a fresh subprocess
(``tests/torch_decode_mesh_ref.py``): ``build_cell``'s decode cell jitted
with its shardings on its own 2 x 2 mesh of 4 XLA host devices.

Weights: the reference's ``init`` perturbed with numpy noise, carried
over by ``models/convert.params_from_reference``; tokens: numpy draws
from a seed.  Batch 4 with 16 cache slots; the batch-1 case
(``gemma3-12b-seq``, the sequence over "data") has 16 slots, 8 or 4 a
data rank, and 20 tokens: the writes cross from one rank's block into the
next, the local layers' ring wraps, the global layer's slot clamps, and
until the first write reaches a rank's block that rank attends nothing.

Tolerances (float32):
- against the port's one-process decode: every step's logits within 1e-5
  of their max |logit| (the blocks' products, and at batch 1 the merge of
  the ranks' partial attentions, sum in other orders: up to 6.4e-7
  measured), the caches' blocks within 1e-5 of the leaf's max, generated
  tokens equal;
- against the reference's sharded decode: ``tests/test_torch_dense.py``'s
  1e-4 (absolute and relative), generated tokens equal.
The token gates mean something only where the top two logits differ by
more than the logit bound; the tests check that they do.
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
from repro_torch.parallel.sharding import MeshShape, mesh_axis_sizes
from repro_torch.serve.engine import DecodeEngine, ServeConfig
from repro_torch.tree import leaves

import torch_mesh_ranks
import torch_ranks
from torch_threads import one_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF_TIMEOUT = 300
# the group runs every case in about 65 s beside the reference's
# subprocess; the limit only stops a hung collective
RANK_TIMEOUT = 300
MESHES = [(2, 2), (4, 1), (1, 4)]
SEQ = 16
# name -> (arch, batch, teacher-forced tokens, prompt lengths, generated,
# meshes)
CASES = {
    "qwen1.5-4b": ("qwen1.5-4b", 4, 10, (6, 4, 5, 6), 4, MESHES),
    "gemma3-12b": ("gemma3-12b", 4, 10, (6, 4, 5, 6), 4, MESHES),
    "qwen2-vl-72b": ("qwen2-vl-72b", 4, 10, (6, 4, 5, 6), 4, MESHES),
    "gemma3-12b-seq": ("gemma3-12b", 1, 20, (12,), 8, [(2, 2), (4, 1)]),
}
COUNT_AT = 2              # the step whose collectives are counted
BLOCK_TOL = 1e-5
REF_TOL = 1e-4
IDS = [f"{c}/{d}x{m}" for c, spec in CASES.items() for d, m in spec[-1]]


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


@pytest.fixture(scope="module")
def case():
    """{case: (reference leaves as numpy, the port's tree, tokens,
    prompts)}."""
    out = {}
    for n, (arch, b, t, lengths, _, _) in CASES.items():
        ref = ref_build_model(REF_SMOKE[arch])
        rng = np.random.default_rng(0)
        tree = jax.tree.map(
            lambda a: np.asarray(a, np.float32)
            + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32),
            ref.init(jax.random.PRNGKey(0))[0])
        tokens = np.random.default_rng(1).integers(
            1, SMOKE[arch].vocab, (b, t)).astype(np.int32)
        out[n] = (jax.tree.leaves(tree),
                  params_from_reference(SMOKE[arch], tree, device="cpu"),
                  tokens, _prompts(arch, b, lengths, 2))
    return out


@pytest.fixture(scope="module")
def ref(case, tmp_path_factory):
    """The reference's sharded decode on its 2 x 2 mesh, started first so
    it runs beside the port's ranks."""
    d = tmp_path_factory.mktemp("decode_mesh_ref")
    arrays = {"names": json.dumps(list(CASES))}
    for n, (ref_leaves, _, tokens, prompts) in case.items():
        arrays.update({f"{n}__arch": CASES[n][0], f"{n}__seq": SEQ,
                       f"{n}__tokens": tokens, f"{n}__gen": CASES[n][4],
                       f"{n}__prompts": _left_padded(prompts)})
        arrays.update({f"{n}__p{i}": a for i, a in enumerate(ref_leaves)})
    np.savez(d / "case.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_decode_mesh_ref.py"),
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
    """{case/mesh: [each rank's result]} from one spawned group of 4."""
    d = tmp_path_factory.mktemp("decode_mesh_ranks")
    cases = {}
    for n, (_, params, tokens, prompts) in case.items():
        arch, _, _, _, gen, meshes = CASES[n]
        cases[n] = {"cfg": dataclasses.asdict(SMOKE[arch]),
                    "params": params, "seq": SEQ,
                    "tokens": torch.from_numpy(tokens), "prompts": prompts,
                    "gen": gen, "meshes": meshes, "count_at": COUNT_AT}
    torch.save({"cases": cases}, d / "case.pt")
    res = torch_ranks.run_ranks(torch_mesh_ranks.decode_mesh_rank, 4,
                                d / "work", str(d / "case.pt"),
                                timeout=RANK_TIMEOUT)
    return {k: [r[k] for r in res] for k in res[0]}


@pytest.fixture(scope="module")
def one(case):
    """The port's one-process decode of each case: every step's logits,
    the caches after the steps, the engine's generation."""
    out = {}
    for n, (_, params, tokens, prompts) in case.items():
        arch, b, _, _, gen, _ = CASES[n]
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
        # the logits each greedy pick reads
        picks = torch.stack(seen[plen - 1:plen - 1 + gen])
        out[n] = {"logits": torch.stack(logits), "caches": leaves(caches),
                  "generated": generated, "picks": picks}
    return out


def _split(cid):
    n, mesh = cid.split("/")
    return n, tuple(map(int, mesh.split("x")))


def _top2_gap(logits):
    top = torch.topk(logits, 2, dim=-1).values
    return float((top[..., 0] - top[..., 1]).min())


@pytest.mark.parametrize("cid", IDS)
def test_ranks_cover_the_mesh_and_agree(ranks, cid):
    _, (d, m) = _split(cid)
    got = ranks[cid]
    assert sorted(r["coord"] for r in got) == [
        (i, j) for i in range(d) for j in range(m)]
    for r in got[1:]:
        assert torch.equal(r["logits"], got[0]["logits"])
        assert torch.equal(r["generated"], got[0]["generated"])
        assert r["collectives"] == got[0]["collectives"]


@pytest.mark.parametrize("cid", IDS)
def test_decode_steps_match_one_process(ranks, one, cid):
    n, _ = _split(cid)
    got, want = ranks[cid][0]["logits"], one[n]["logits"]
    assert got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= BLOCK_TOL * float(w.abs().max())


@pytest.mark.parametrize("cid", IDS)
def test_generate_matches_one_process(ranks, one, cid):
    """``DecodeEngine.generate`` on the placed parameters: the caches and
    tokens laid out by the cell's shardings, the greedy pick on the
    vocab-sharded logits."""
    n, _ = _split(cid)
    got = ranks[cid][0]["generated"].numpy()
    assert got.shape == (CASES[n][1], CASES[n][4])
    np.testing.assert_array_equal(got, one[n]["generated"])


def test_the_token_gates_have_room(one):
    """No greedy pick of the generations is a tie within the logit
    bounds: at each, the top two logits differ by more than the reference
    bound of the max |logit|."""
    for n, res in one.items():
        lg = res["picks"]
        assert lg.shape[0] == CASES[n][4]
        assert _top2_gap(lg) > REF_TOL * float(lg.abs().max()), n


@pytest.mark.parametrize("cid", IDS)
def test_cache_blocks_match_one_process(ranks, one, cid):
    n, _ = _split(cid)
    want = one[n]["caches"]
    for r in ranks[cid]:
        assert len(r["caches"]) == len(want)
        for (bounds, block, _), w in zip(r["caches"], want):
            ref = w[tuple(slice(*b) for b in bounds)]
            assert block.shape == ref.shape
            scale = max(float(w.abs().max()), 1.0)
            assert float((block.float() - ref.float()).abs().max()) <= \
                BLOCK_TOL * scale


@pytest.mark.parametrize("cid", IDS)
def test_place_cell_gives_each_rank_its_cache_block(ranks, cid):
    """Each rank holds exactly its ``cache_shardings`` block of every
    cache leaf, and the blocks of all ranks tile the leaf."""
    n, mesh = _split(cid)
    d = mesh[0]
    arch, b = CASES[n][:2]
    model = build_model(SMOKE[arch])
    shape = MeshShape(("data", "model"), mesh)
    want = leaves(steps.cache_shardings(model, shape, b, SEQ,
                                        seq_shard=b == 1))
    specs = leaves(steps._meta(model.cache_specs(b, SEQ, torch.float32)))
    covered = [set() for _ in want]
    for r in ranks[cid]:
        for i, ((bounds, block, placements), sh, whole) in enumerate(
                zip(r["caches"], want, specs)):
            assert tuple(block.shape) == sh.shard_shape(tuple(whole.shape))
            assert placements == str(sh.placements)
            covered[i].add(bounds)
    for sh, whole, got in zip(want, specs, covered):
        blocks_n = np.prod(whole.shape) // np.prod(
            sh.shard_shape(tuple(whole.shape)))
        assert len(got) == blocks_n
    # units[0]["k"], [repeats, B, Hkv, S, hd]: at batch 1 the sequence
    # over "data", else the batch
    assert want[0].spec[3 if b == 1 else 1] == ("data" if d > 1 else None) \
        or d == 1


@pytest.mark.parametrize("cid", IDS)
def test_serve_layout_gathers_no_parameter(ranks, cid):
    """Weight-stationary: ``build_cell`` drops the "data" split of every
    weight (the smoke configs are far under its 10e9 bytes a device), and
    the step's collectives gather no parameter.  Its all-gathers are
    activations: none where the model axis splits both head counts or
    neither, else one a layer of the queries' block [B/d, Hq/m, 1, hd]
    (whole GQA groups, as in ``_attention``)."""
    n, (d, m) = _split(cid)
    arch, b = CASES[n][:2]
    cfg = SMOKE[arch]
    r0 = ranks[cid][0]
    for _, placements, _ in r0["param_layout"]:
        # the data mesh dim (first) replicates every weight
        assert placements.startswith("(Replicate()")
    split = [cfg.n_heads % m == 0, cfg.n_kv_heads % m == 0]
    coll = r0["collectives"]
    if all(split) or not any(split):
        assert coll["all-gather"] == 0 and r0["gathers"] == []
    else:
        q_block = (b // d, cfg.n_heads // m, 1, cfg.hd)
        assert r0["gathers"] == [q_block] * cfg.n_layers
    assert coll["reduce-scatter"] == 0
    # nothing to add where neither "model" splits a product nor "data" a
    # cache's slots
    assert (coll["count"] > 0) == (m > 1 or (b == 1 and d > 1))


def test_sequence_sharded_writes_cross_blocks_and_wrap(ranks, one):
    """gemma3's batch-1 cell: the caches' sequence over "data"; the 20
    tokens cross each data rank's block boundary (8 or 4 slots), wrap the
    local layers' 16-slot ring and clamp the global layer at its last
    slot.  Before the writes reach a rank's block, it attends nothing and
    still gives finite logits; afterwards every block holds keys."""
    n = "gemma3-12b-seq"
    cfg = SMOKE[CASES[n][0]]
    steps_n = CASES[n][2]
    assert steps_n > SEQ and cfg.window > SEQ
    for d, m in CASES[n][-1]:
        got = ranks[f"{n}/{d}x{m}"]
        assert SEQ // d < steps_n
        for r in got:
            assert bool(torch.isfinite(r["logits"]).all())
            (bounds, k_block, placements) = r["caches"][0]
            # [repeats, B, Hkv, S, hd]: this rank's slots
            assert bounds[3][1] - bounds[3][0] == SEQ // d
            assert float(k_block.abs().max()) > 0


@pytest.mark.parametrize("n", list(CASES))
def test_sharded_decode_matches_the_references(ranks, ref_out, n):
    """At 2 x 2, against the reference's cell jitted with its shardings,
    while no global layer's cache is full (every step of the batch-4
    cases, gemma3-12b-seq's first 16), and against the reference's
    unsharded decode, whose semantics the port keeps, on every step: the
    logits, the cache blocks, the generated tokens."""
    r0 = ranks[f"{n}/2x2"][0]
    got = r0["logits"].numpy()
    full = min(got.shape[0], SEQ)
    np.testing.assert_allclose(got[:full], ref_out[f"{n}__logits"][:full],
                               atol=REF_TOL, rtol=REF_TOL)
    np.testing.assert_allclose(got, ref_out[f"{n}__plain_logits"],
                               atol=REF_TOL, rtol=REF_TOL)
    for i, (bounds, block, _) in enumerate(r0["caches"]):
        want = ref_out[f"{n}__plain_cache{i}"][
            tuple(slice(*b) for b in bounds)]
        np.testing.assert_allclose(block.numpy(), want, atol=REF_TOL,
                                   rtol=REF_TOL)
    gen = r0["generated"].numpy()
    np.testing.assert_array_equal(gen, ref_out[f"{n}__plain_generated"])
    if max(CASES[n][3]) + CASES[n][4] <= SEQ:
        np.testing.assert_array_equal(gen, ref_out[f"{n}__generated"])


def test_the_references_sharded_cell_drops_writes_past_a_full_cache(
        ref_out):
    """The reference's own fault, pinned: at batch 1 with the sequence over
    "data", once the global layer's 16 slots are full its sharded cell
    (XLA's partitioned ``dynamic_update_slice``) stops writing, where its
    unsharded decode clamps the write to the last slot; the logits part
    from step 16 on."""
    n = "gemma3-12b-seq"
    sharded, plain = ref_out[f"{n}__logits"], ref_out[f"{n}__plain_logits"]
    err = np.abs(sharded - plain).max(axis=(1, 2))
    assert err[:SEQ].max() <= REF_TOL
    assert err[SEQ:].min() > 100 * REF_TOL


def test_decode_projection_is_the_prefills_product():
    """The decode step's output projection is ``_heads_out``'s flattened
    product (one layout rule for prefill and decode on DTensors); on plain
    tensors it gives the reference einsum's bits."""
    g = torch.Generator().manual_seed(5)
    for b, h, hd, d in ((4, 4, 32, 128), (2, 20, 128, 2560), (1, 16, 256,
                                                             3840)):
        o = torch.randn(b, h, hd, generator=g)
        wo = torch.randn(h, hd, d, generator=g)
        got = blocks._heads_out(o[:, :, None], wo)
        want = torch.einsum("bhk,hkd->bd", o, wo)[:, None]
        assert torch.equal(got, want)


def test_serve_layout_rule_at_full_width():
    """``build_cell``'s rule at the meshes of the card's phase: qwen1.5-4b
    and gemma3-12b's one-unit cut keep no weight split over "data" on a
    (2, 2) mesh (n_params x 2 / 2 under 10e9 bytes)."""
    from repro_torch.configs.archs import ARCHS
    from repro_torch.configs.shapes import Shape

    mesh = MeshShape(("data", "model"), (2, 2))
    for arch, layers, b, s in (("qwen1.5-4b", 40, 4, 2048),
                               ("gemma3-12b", 6, 1, 64)):
        cfg = dataclasses.replace(ARCHS[arch], n_layers=layers)
        assert cfg.n_params() * 2 / mesh_axis_sizes(mesh)["model"] < 10e9
        _, _, in_sh, _, _ = steps.build_cell(
            cfg, Shape("decode", s, b, "decode"), mesh)
        for sh in leaves(in_sh[0]):
            assert "data" not in str(sh.spec)
