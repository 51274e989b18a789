"""The port's ``collective_bytes``: ``launch/collectives.py``'s counter on
known redistributions over 4 gloo ranks, held to the reference's
``collective_bytes`` of the same redistributes jitted over 4 XLA host
devices (``tests/torch_collectives_ref.py``, a fresh subprocess), the step
at a 1 x 1 mesh, and the dry run's ``--collectives`` at 16 x 16;
``parallel/host_staged.py``'s and ``parallel/peer_staged.py``'s staging
on the same redistributions; the
DTensor helpers of ``parallel/sharding.py`` on plain tensors.

Ranks are spawned by ``tests/torch_ranks.py`` (bodies in
``tests/torch_mesh_ranks.py``); no process group runs in the pytest
worker.  The dry run is a fresh subprocess (its fake process group of 256
ranks is a process-wide group).
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.archs import ARCHS, SMOKE
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.collectives import KEYS, collective_kind
from repro_torch.models.registry import build_model
from repro_torch.parallel import peer_staged
from repro_torch.parallel.sharding import (
    MeshShape, NamedSharding, replicate_like, shard, spec_map,
)

import torch_mesh_ranks
import torch_ranks

ROOT = pathlib.Path(__file__).resolve().parents[1]
DRY_TIMEOUT = 300
# float32 [8, 16] over 4 ranks: 512 B whole, 128 B a block
REDISTRIBUTES = {
    "shard_to_replicate": ("all-gather", 512),
    "partial_to_replicate": ("all-reduce", 512),
    "partial_to_shard": ("reduce-scatter", 128),
    "c10d_all_reduce": ("all-reduce", 512),
}
# where the reference's HLO holds another collective: XLA's CPU backend
# lowers a partial sum to a row-sharded result as an all-reduce of the
# whole tensor and a slice of it, the reduce-scatter's block times the mesh
REF_KINDS = {"partial_to_shard": ("all-reduce", 4)}


@pytest.fixture(scope="module")
def redistributed(tmp_path_factory):
    d = tmp_path_factory.mktemp("redistribute")
    return torch_ranks.run_ranks(torch_mesh_ranks.redistribute_rank, 4,
                                 d / "work")


@pytest.mark.parametrize("case", sorted(REDISTRIBUTES))
def test_counter_counts_a_known_redistribute(redistributed, case):
    kind, nbytes = REDISTRIBUTES[case]
    want = {**dict.fromkeys(KEYS, 0), kind: nbytes, "count": 1}
    for rank in redistributed:
        assert rank[case]["counts"] == want
        assert rank[case]["right"]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("collectives_ref") / "out.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_collectives_ref.py"),
         str(out)], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=DRY_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("case", sorted(REDISTRIBUTES))
def test_counter_matches_the_references_collective_bytes(redistributed,
                                                         reference, case):
    kind, nbytes = REDISTRIBUTES[case]
    ref_kind, scale = REF_KINDS.get(case, (kind, 1))
    assert reference[case] == {**dict.fromkeys(KEYS, 0),
                               ref_kind: scale * nbytes, "count": 1,
                               "count_static": 1}
    for rank in redistributed:
        got = rank[case]["counts"]
        assert scale * got[kind] == reference[case][ref_kind]
        assert got["count"] == reference[case]["count"]


@pytest.mark.parametrize("case", sorted(set(REDISTRIBUTES)
                                        - {"c10d_all_reduce"}))
def test_host_staged_collectives_give_the_same_values(redistributed, case):
    for rank in redistributed:
        got = rank[f"staged/{case}"]
        assert got["right"]
        assert sum(got["staged"].values()) >= 1
        assert all(k.startswith("_c10d_functional")
                   or k.startswith("_dtensor") for k in got["staged"])


@pytest.mark.parametrize("case", sorted(set(REDISTRIBUTES)
                                        - {"c10d_all_reduce"}))
def test_peer_staged_collectives_give_the_same_values(redistributed, case):
    """The same redistributes through ``parallel/peer_staged.py``'s
    buffers (files mapped shared, for CPU tensors) give the same values,
    each through the peer path."""
    for rank in redistributed:
        got = rank[f"peer/{case}"]
        assert got["right"]
        assert sum(got["staged"].values()) >= 1
        assert set(got["staged"]) <= set(peer_staged._PEER)


def test_peer_buffers_follow_inputs_that_grow_and_shrink(redistributed):
    """A group's buffers grow past an input that outgrows them (the peers
    map each new generation), serve smaller inputs after, and carry an
    int64 and a 0-d sum bit for bit."""
    for rank in redistributed:
        got = rank["peer/growing"]
        assert len(got["right"]) == 16 and all(got["right"])
        assert set(got["staged"]) == set(peer_staged._PEER)


@pytest.mark.parametrize("name,kind", [
    ("_c10d_functional::all_gather_into_tensor", "all-gather"),
    ("_c10d_functional::reduce_scatter_tensor", "reduce-scatter"),
    ("_c10d_functional::all_reduce", "all-reduce"),
    ("c10d::allreduce_", "all-reduce"),
    ("_c10d_functional::wait_tensor", None),
    ("aten::mm", None),
    ("_dtensor::shard_dim_alltoall", "all-to-all"),
    ("_c10d_functional::all_to_all_single", NotImplementedError),
])
def test_one_table_names_the_collectives(name, kind):
    """The counter and the host staging read one table; a collective of
    DTensor's namespaces outside it raises rather than pass uncounted."""
    if kind is NotImplementedError:
        with pytest.raises(NotImplementedError):
            collective_kind(name)
    else:
        assert collective_kind(name) == kind


def test_one_rank_mesh_runs_no_collective(tmp_path):
    cfg = SMOKE["qwen1.5-4b"]
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        1, cfg.vocab, (2, 16)).astype(np.int32))
    torch.save({"cfg": dataclasses.asdict(cfg),
                "params": build_model(cfg).init(0, device="cpu"),
                "tokens": tokens}, tmp_path / "case.pt")
    (res,) = torch_ranks.run_ranks(torch_mesh_ranks.one_rank_step, 1,
                                   tmp_path / "work",
                                   str(tmp_path / "case.pt"))
    assert res["counts"] == {**dict.fromkeys(KEYS, 0), "count": 0}
    assert bool(torch.isfinite(res["loss"]))


def test_dryrun_counts_the_train_cells_collectives(tmp_path):
    out = tmp_path / "dry.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen1.5-4b", "--shape", "train_4k", "--mesh", "16x16",
         "--collectives", "--out", str(out)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=DRY_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    (rec,) = json.loads(out.read_text())
    coll = rec["collectives"]
    assert set(coll) == set(KEYS) | {"count"}
    assert coll["count"] > 0 and coll["all-gather"] > 0
    # a shard-to-shard redistribute counted as a card runs it
    assert coll["all-to-all"] > 0
    assert all(v >= 0 for v in coll.values())
    assert "dt-coll " in proc.stdout
    t = roofline.terms(rec, ARCHS["qwen1.5-4b"])
    assert t["t_collective"] is not None and t["t_collective"] > 0
    assert t["coll_gb"] == pytest.approx(
        sum(v for k, v in coll.items() if k != "count") / 1e9)


# the smoke-config dry run: every shape cut to a few tokens (a name's
# kind and its batch-1 case kept)
SMALL = {"train_4k": (32, 8), "prefill_32k": (32, 4), "decode_32k": (64, 8),
         "long_500k": (64, 1)}
CELLS = [
    ("qwen1.5-4b", "train_4k"), ("gemma3-12b", "prefill_32k"),
    ("qwen2-vl-72b", "train_4k"), ("qwen1.5-4b", "decode_32k"),
    ("phi3-mini-3.8b", "decode_32k"), ("gemma3-12b", "decode_32k"),
    ("qwen2.5-32b", "decode_32k"), ("qwen2-vl-72b", "decode_32k"),
    ("gemma3-12b", "long_500k"), ("mixtral-8x7b", "decode_32k"),
    ("kimi-k2-1t-a32b", "decode_32k"), ("mixtral-8x7b", "long_500k"),
    ("rwkv6-7b", "decode_32k"), ("rwkv6-7b", "long_500k"),
    ("zamba2-7b", "decode_32k"), ("zamba2-7b", "long_500k"),
    ("whisper-large-v3", "decode_32k"), ("mixtral-8x7b", "train_4k"),
    ("rwkv6-7b", "prefill_32k"), ("zamba2-7b", "train_4k"),
    ("rwkv6-7b", "train_4k"), ("zamba2-7b", "prefill_32k"),
    ("whisper-large-v3", "train_4k"),
]


@pytest.fixture(scope="module")
def smoke_dryrun(tmp_path_factory):
    """``run_cell`` with ``collectives`` for each of :data:`CELLS` at the
    smoke configs, the shapes cut to :data:`SMALL`, on a 2 x 2 mesh of a
    fake world of 4, in a fresh subprocess."""
    out = tmp_path_factory.mktemp("smoke_dry") / "dry.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = (
        "import json, sys\n"
        "from repro_torch.configs.archs import SMOKE\n"
        "from repro_torch.configs.shapes import SHAPES, Shape\n"
        "from repro_torch.launch import dryrun\n"
        "from repro_torch.parallel.sharding import MeshShape\n"
        "small = json.loads(sys.argv[2])\n"
        "dryrun.ARCHS = SMOKE\n"
        "dryrun.SHAPES = {n: Shape(n, *small[n], s.kind) "
        "for n, s in SHAPES.items()}\n"
        "dryrun.MESHES['2x2'] = lambda: MeshShape(('data', 'model'), "
        "(2, 2))\n"
        "with dryrun.fake_world(4):\n"
        "    recs = [dryrun.run_cell(a, s, '2x2', True) "
        "for a, s in json.loads(sys.argv[3])]\n"
        "json.dump(recs, open(sys.argv[1], 'w'))")
    proc = subprocess.run([sys.executable, "-c", code, str(out),
                           json.dumps(SMALL), json.dumps(CELLS)], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=DRY_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return {(r["arch"], r["shape"]): r for r in json.loads(out.read_text())}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_dryrun_counts_every_cell(smoke_dryrun, arch, shape):
    """Every family's cells are counted on DTensors, the MoE and
    encoder-decoder ones too (no cell is left uncounted but by
    ``skip_reason``): the smoke config's step on fake tensors over a 2 x 2
    mesh issues collectives, and no reduce-scatter without a gradient."""
    rec = smoke_dryrun[(arch, shape)]
    assert "skipped" not in rec and not hasattr(dryrun, "SKIPPED")
    coll = rec["collectives"]
    assert set(coll) == set(KEYS) | {"count"}
    assert coll["count"] > 0 and all(v >= 0 for v in coll.values())
    if SHAPES[shape].kind != "train":
        assert coll["reduce-scatter"] == 0


def test_dryrun_counts_the_decode_cells_collectives(tmp_path):
    """The decode cells at 16 x 16: qwen1.5-4b's decode_32k (the serve
    layout, batch over "data") and gemma3-12b's long_500k (batch 1, the KV
    sequence over "data": each global layer merges the ranks' partial
    attentions), the recurrent families' decode_32k (rwkv6-7b's and
    zamba2-7b's states by batch and heads), the MoE and encoder-decoder
    decode_32k (mixtral-8x7b's and kimi-k2's shard_map MoE on each rank's
    blocks, whisper-large-v3's cross caches by batch and heads) and
    rwkv6-7b's train_4k (the WKV kernel's shape-only path on fake tensors,
    forward and backward), counted on fake tensors, each with
    collectives; the decode cells with no reduce-scatter (no
    gradient)."""
    out = tmp_path / "dry.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cells = [("qwen1.5-4b", "decode_32k"), ("qwen1.5-4b", "long_500k"),
             ("gemma3-12b", "decode_32k"), ("gemma3-12b", "long_500k"),
             ("rwkv6-7b", "decode_32k"), ("zamba2-7b", "decode_32k"),
             ("mixtral-8x7b", "decode_32k"), ("kimi-k2-1t-a32b", "decode_32k"),
             ("whisper-large-v3", "decode_32k"), ("rwkv6-7b", "train_4k")]
    code = ("import json, sys; from repro_torch.launch import dryrun; "
            "cells = json.loads(sys.argv[2])\n"
            "with dryrun.fake_world(256):\n"
            "    recs = [dryrun.run_cell(a, s, '16x16', True) "
            "for a, s in cells]\n"
            "json.dump(recs, open(sys.argv[1], 'w'))")
    proc = subprocess.run([sys.executable, "-c", code, str(out),
                           json.dumps(cells)], cwd=ROOT, env=env,
                          capture_output=True, text=True,
                          timeout=DRY_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    recs = {(r["arch"], r["shape"]): r for r in json.loads(out.read_text())}
    assert "skipped" in recs[("qwen1.5-4b", "long_500k")]
    for cell in cells:
        if cell == ("qwen1.5-4b", "long_500k"):
            continue
        coll = recs[cell]["collectives"]
        assert coll["count"] > 0 and coll["all-reduce"] > 0
        assert (coll["reduce-scatter"] == 0) == \
            (SHAPES[cell[1]].kind == "decode")
        t = roofline.terms(recs[cell], ARCHS[cell[0]])
        assert t["t_collective"] is not None and t["t_collective"] > 0
    # qwen1.5-4b: 20 heads on 16 replicate, so attention adds nothing over
    # "model": one all-reduce a layer (the MLP's) and the embedding's
    assert recs[("qwen1.5-4b", "decode_32k")]["collectives"]["count"] == \
        ARCHS["qwen1.5-4b"].n_layers + 1
    # zamba2-7b's step gathers its in-projection's activations over
    # "model", one a Mamba2 layer, and no parameter; rwkv6-7b's none
    assert recs[("zamba2-7b", "decode_32k")]["collectives"]["all-gather"] > 0
    assert recs[("rwkv6-7b", "decode_32k")]["collectives"]["all-gather"] == 0
    # the shard_map MoE: one all-reduce of the partial output a MoE layer,
    # beside the attention's and the embedding's; whisper's decode step
    # gathers nothing (its 20 heads on 16 replicate)
    for arch in ("mixtral-8x7b", "kimi-k2-1t-a32b"):
        assert recs[(arch, "decode_32k")]["collectives"]["all-reduce"] > 0
        assert recs[(arch, "decode_32k")]["collectives"]["count"] > \
            ARCHS[arch].n_layers
    assert recs[("whisper-large-v3", "decode_32k")]["collectives"][
        "all-gather"] == 0


def test_dtensor_helpers_leave_plain_tensors_alone():
    x = torch.randn(4, 6)
    assert shard(x, ("batch", None)) is x
    assert replicate_like(x, torch.zeros(())) is x


def test_spec_map_walks_named_shardings():
    mesh = MeshShape(("data", "model"), (2, 4))
    tree = {"a": NamedSharding(mesh, ("data", None)),
            "b": (NamedSharding(mesh, (None, "model")),)}
    shapes = {"a": torch.empty(8, 8, device="meta"),
              "b": (torch.empty(8, 8, device="meta"),)}
    got = spec_map(lambda sh, t: sh.shard_shape(tuple(t.shape)), tree,
                   shapes)
    assert got == {"a": (4, 8), "b": ((8, 2),)}
