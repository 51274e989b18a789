"""The port's parallel layer (``repro_torch.parallel.sharding``,
``launch/mesh.py``, the param specs, the sharding helpers of
``launch/steps.py``) against the JAX reference, on the CPU.

The reference side of the production meshes runs once, in a fresh
subprocess (``tests/torch_mesh_ref.py``, the 512-device XLA flag
before its first ``jax`` import, under a time limit); the port resolves
the same layouts over ``MeshShape``s, with no devices.  Everything here is
integer arithmetic on shapes, so every comparison is exact.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs.archs import SMOKE as REF_SMOKE
from repro.models.registry import build_model as ref_build_model
from repro.parallel import sharding as ref_sharding
from repro_torch.configs.archs import ARCHS, SMOKE
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps
from repro_torch.models.registry import build_model
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import MeshShape, NamedSharding
from torch_threads import one_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF_TIMEOUT = 300
MESHES = {"16x16": mesh_mod.make_production_mesh(),
          "2x16x16": mesh_mod.make_production_mesh(multi_pod=True)}


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


def _spec_json(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _flat(tree, path=()):
    """{"a/0/b": leaf} over dicts, tuples and NamedTuples (by field
    name), as the reference's tree paths print."""
    if tree is None:
        return {}
    if isinstance(tree, (torch.Tensor, NamedSharding)):
        return {"/".join(path): tree}
    if isinstance(tree, dict):
        keys = [(str(k), v) for k, v in tree.items()]
    elif hasattr(tree, "_fields"):
        keys = list(zip(tree._fields, tree))
    else:
        keys = [(str(i), v) for i, v in enumerate(tree)]
    out = {}
    for k, v in keys:
        out.update(_flat(v, path + (k,)))
    return out


def _layout(shardings, shapes):
    sh, sd = _flat(shardings), _flat(shapes)
    assert sh.keys() == sd.keys()
    return {k: [_spec_json(s.spec), list(sd[k].shape),
                list(s.shard_shape(tuple(sd[k].shape)))]
            for k, s in sh.items()}


def test_rules_are_the_references():
    assert sharding.RULES == ref_sharding.RULES


@pytest.mark.parametrize("logical,shape", [
    (("batch", None), None), (("batch", None), (1, 7)),
    (("embed_fsdp", "kv_heads", None), (4096, 8, 128)),
    (("vocab", "embed_fsdp"), (51866, 1280)), (("stack", "mlp"), (3, 48)),
    (("lanes", "plane_fields"), (64, 18)), (("unknown", None), (4, 4)),
])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_resolve_matches_the_reference(logical, shape, mesh):
    m = MESHES[mesh]
    ref_mesh = jax.sharding.AbstractMesh(m.sizes, m.axis_names)
    want = ref_sharding.resolve(logical, ref_mesh, shape=shape)
    assert sharding.resolve(logical, m, shape=shape) == tuple(want)


def test_mesh_shapes_and_constants():
    assert MESHES["16x16"].shape == {"data": 16, "model": 16}
    assert MESHES["2x16x16"].shape == {"pod": 2, "data": 16, "model": 16}
    assert sharding.mesh_size(mesh_mod.make_card_mesh()) == 1
    assert (mesh_mod.PEAK_FLOPS_BF16, mesh_mod.HBM_BW,
            mesh_mod.NVLINK_BW) == (989e12, 3.35e12, 450e9)


def test_placements_and_shard_shape():
    from torch.distributed.tensor import Replicate, Shard
    m = MESHES["2x16x16"]
    spec = (("pod", "data"), None, "model")
    assert sharding.placements(spec, m) == (Shard(0), Shard(0), Shard(2))
    assert sharding.placements((None, "model"), m) == (
        Replicate(), Replicate(), Shard(1))
    assert sharding.shard_shape((64, 3, 32), spec, m) == (2, 3, 2)
    with pytest.raises(ValueError):
        sharding.shard_shape((48, 3, 32), spec, m)
    with pytest.raises(ValueError):
        sharding.placements(("data", "data"), m)


def test_use_mesh_restores_on_exit_and_on_error():
    a, b = MESHES["16x16"], MESHES["2x16x16"]
    assert sharding.current_mesh() is None
    with sharding.use_mesh(a):
        with pytest.raises(RuntimeError):
            with sharding.use_mesh(b):
                assert sharding.current_mesh() is b
                raise RuntimeError
        assert sharding.current_mesh() is a
    assert sharding.current_mesh() is None


@pytest.mark.parametrize("name", sorted(SMOKE))
def test_param_specs_equal_the_references(name):
    _, want = ref_build_model(REF_SMOKE[name]).init(jax.random.PRNGKey(0))
    model = build_model(SMOKE[name])
    got = model.param_specs()
    assert got == want
    # one spec a parameter, with one entry a dim
    shapes = model.param_shapes()
    flat = _flat(sharding.spec_map(
        lambda sp, t: NamedSharding(MESHES["16x16"], sp), got, shapes))
    for k, t in _flat(shapes).items():
        assert len(flat[k].spec) == t.dim(), k


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_full_config_layouts_equal_the_references(ref, arch, mesh):
    """resolve + shard_shape for every parameter leaf of a full config."""
    shapes, specs = steps.abstract_init(build_model(ARCHS[arch]))
    got = _layout(steps.param_shardings(specs, shapes, MESHES[mesh]),
                  shapes)
    want = ref["params"][arch][mesh]
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], (k, got[k], want[k])


def _cells():
    return ["kimi-k2-1t-a32b/train_4k", "qwen2-vl-72b/prefill_32k",
            "whisper-large-v3/decode_32k", "zamba2-7b/decode_32k",
            "mixtral-8x7b/long_500k", "rwkv6-7b/long_500k"]


@pytest.mark.parametrize("cell", _cells())
def test_build_cell_matches_the_reference(ref, cell):
    arch, shape = cell.split("/")
    mesh = MESHES["16x16"]
    fn, args, in_sh, out_sh, donate = steps.build_cell(
        ARCHS[arch], SHAPES[shape], mesh)
    want = ref["cells"][cell]
    assert callable(fn)
    assert list(donate) == want["donate"]
    assert [_layout(s, a) for s, a in zip(in_sh, args)] == want["in"]
    got_out = None if out_sh is None else [
        None if s is None else _layout(s, a) for s, a in zip(out_sh, args)]
    assert got_out == want["out"]
    # every argument leaf is a meta tensor; its placements are the
    # reference spec's, read mesh axis by mesh axis
    for a, s, w in zip(args, in_sh, want["in"]):
        for k, sh in _flat(s).items():
            assert _flat(a)[k].device.type == "meta"
            assert sh.placements == _ref_placements(w[k][0], mesh), k


def _ref_placements(spec, mesh):
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in mesh.axis_names:
        dims = [d for d, e in enumerate(spec)
                if e == axis or (isinstance(e, list) and axis in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def test_opt_state_specs_and_cache_names():
    from repro_torch.optim import adamw
    specs = build_model(SMOKE["zamba2-7b"]).param_specs()
    o = steps.opt_state_specs(specs, adamw.AdamWConfig())
    assert o.step == () and o.m is specs and o.v is specs and o.err is None
    o = steps.opt_state_specs(specs, adamw.AdamWConfig(compress_grads=True))
    assert o.err is specs
    m = MeshShape(("data", "model"), (2, 2))
    c = steps.cache_shardings(build_model(SMOKE["zamba2-7b"]), m, 4, 64,
                              seq_shard=False)
    assert c["units"][0]["ssm"].spec == (None, "data", "model", None, None)
    assert c["shared"]["k"].spec == (None, "data", "model", None, None)
    assert c["units"][0]["conv"].spec == (None, "data", None, None)
    assert c["shared"]["length"].spec == (None,)
    assert P(*c["shared"]["k"].spec) == P(None, "data", "model", None, None)
