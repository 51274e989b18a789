"""The port's roofline (``repro_torch.launch.roofline``) and dry run
(``repro_torch.launch.dryrun``) against the JAX reference, on the CPU.

The analytic FLOP and byte models are the reference's arithmetic, so they
compare with ``==`` on all 34 (arch x shape) cells.  The dry run's
per-device parameter bytes are held to the sum of the reference's shard
shapes on the 16 x 16 production mesh, computed once in a fresh
subprocess (``tests/torch_mesh_ref.py``, under a time limit).
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro.configs.archs import ARCHS as REF_ARCHS
from repro.configs.shapes import SHAPES as REF_SHAPES
from repro.launch import roofline as ref_roofline
from repro_torch.configs.archs import ARCHS
from repro_torch.configs.shapes import SHAPES, cells
from repro_torch.launch import dryrun, roofline
from repro_torch.models.registry import build_model
from repro_torch.tree import leaves
from torch_threads import one_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF_TIMEOUT = 300
CELLS = [(a, s.name) for a in sorted(ARCHS) for s in cells(a)]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "ref.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_mesh_ref.py"),
         "sharding", str(out)], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=REF_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(out.read_text())


def test_thirty_four_cells():
    assert len(CELLS) == 34


@pytest.mark.parametrize("arch,shape", CELLS)
def test_analytic_counts_equal_the_references(arch, shape):
    cfg, rcfg = ARCHS[arch], REF_ARCHS[arch]
    sh, rsh = SHAPES[shape], REF_SHAPES[shape]
    assert roofline.analytic_flops(cfg, sh) == \
        ref_roofline.analytic_flops(rcfg, rsh)
    assert roofline.analytic_hbm_bytes(cfg, sh) == \
        ref_roofline.analytic_hbm_bytes(rcfg, rsh)
    assert roofline.kv_cache_bytes(cfg, sh.global_batch, sh.seq_len) == \
        ref_roofline.kv_cache_bytes(rcfg, rsh.global_batch, rsh.seq_len)
    assert roofline._attn_flops(cfg, 4096, sh.seq_len, train=True) == \
        ref_roofline._attn_flops(rcfg, 4096, rsh.seq_len, train=True)


@pytest.mark.parametrize("arch,shape", [("mixtral-8x7b", "prefill_32k"),
                                        ("rwkv6-7b", "decode_32k")])
def test_terms_use_the_h100_constants(arch, shape):
    cfg, sh = ARCHS[arch], SHAPES[shape]
    rec = dryrun.run_cell(arch, shape, "1xH100")
    assert rec["chips"] == 1 and rec["collectives"] is None
    t = roofline.terms(rec, cfg)
    assert t["t_compute"] == roofline.analytic_flops(cfg, sh) / 989e12
    assert t["t_memory"] == roofline.analytic_hbm_bytes(cfg, sh) / 3.35e12
    assert t["t_collective"] is None
    assert t["dominant"] in ("compute", "memory")
    assert t["bound_s"] == max(t["t_compute"], t["t_memory"])
    # with collective bytes, NVLink's 450 GB/s a direction
    t2 = roofline.terms(dict(rec, collectives={
        "all-reduce": 900e9, "count": 3}), cfg)
    assert t2["t_collective"] == 2.0 and t2["coll_gb"] == 900.0
    table = roofline.fmt_table([t, t2])
    assert "n/a" in table and arch in table


def test_one_card_records_cover_every_cell():
    recs = [r for r in dryrun.run_all("1xH100") if "skipped" not in r]
    assert sorted((r["arch"], r["shape"]) for r in recs) == sorted(CELLS)
    for r in recs:
        b = r["bytes_per_device"]
        shapes = build_model(ARCHS[r["arch"]]).param_shapes()
        assert b["params"] == 2 * sum(t.numel() for t in leaves(shapes))
        assert b["total"] == sum(v for k, v in b.items() if k != "total")
        assert r["flops"] > 0 and r["hbm_bytes"] > 0


@pytest.mark.parametrize("arch,shape", CELLS)
def test_dryrun_param_bytes_equal_the_references(ref, arch, shape):
    rec = dryrun.run_cell(arch, shape, "16x16")
    assert rec["chips"] == 256
    assert rec["bytes_per_device"]["params"] == \
        ref["param_bytes"][f"{arch}/{shape}"]
