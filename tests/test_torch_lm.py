"""The port's model-serving path against the JAX reference, on the CPU.

Weights are drawn by the reference (``LM.init`` / block inits), perturbed
with numpy noise so that no bias or scale is trivially 0 or 1, and carried
over with ``params_from_reference`` (blocks: a plain tree copy).  Inputs
come from numpy with a seed.  The reference runs its jnp paths
(``impl="xla"``), never Pallas.  Tolerances: 2e-5 for single blocks, 1e-4
for model logits (float32).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.archs import SMOKE as REF_SMOKE
from repro.coord.registry import PaxosRegistry as RefRegistry
from repro.models import blocks as ref_blocks
from repro.models import common as ref_common
from repro.models.registry import build_model as ref_build_model
from repro.serve.engine import DecodeEngine as RefEngine
from repro.serve.engine import ServeConfig as RefServeConfig
from repro_torch.configs.archs import ARCHS, SMOKE
from repro_torch.configs.shapes import Shape
from repro_torch.coord.registry import PaxosRegistry
from repro_torch.launch.steps import make_prefill
from repro_torch.models import blocks, common
from repro_torch.models.convert import params_from_reference
from repro_torch.models.lm import LM
from repro_torch.models.registry import build_model, input_specs
from repro_torch.serve.engine import DecodeEngine, ServeConfig
from torch_threads import one_thread  # noqa: F401 (autouse)

BLOCK_TOL = 2e-5
LOGIT_TOL = 1e-4
CPU = torch.device("cpu")


def _perturb(tree, seed):
    """The reference tree with seeded noise on every leaf (numpy)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32), tree)


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)),
                        tree)


def _ref_init(fn, cfg, seed, *args):
    params, _ = fn(cfg, ref_common.Init(jax.random.PRNGKey(seed)), *args)
    return _perturb(params, seed)


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _cfg(name, **kw):
    return dataclasses.replace(SMOKE[name], **kw), \
        dataclasses.replace(REF_SMOKE[name], **kw)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def test_rms_norm_rope_positions_match_ref():
    x = _x(0, 2, 4, 10, 32)
    scale = 1.0 + _x(1, 32)
    _close(common.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)),
           ref_common.rms_norm(jnp.asarray(x), jnp.asarray(scale)),
           BLOCK_TOL)
    pos = np.arange(10, dtype=np.int32)[None] + np.array([[0], [7]],
                                                         np.int32)
    _close(common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             5e5),
           ref_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), 5e5),
           BLOCK_TOL)
    assert np.array_equal(common.default_positions(3, 5, 2).numpy(),
                          np.asarray(ref_common.default_positions(3, 5, 2)))


@pytest.mark.parametrize("norm", ["rms", "layer"])
def test_norm_apply_matches_ref(norm):
    cfg, rcfg = _cfg("qwen1.5-4b", norm=norm)
    p = _ref_init(lambda c, i: (ref_blocks.init_norm(c, i)[0], None),
                  rcfg, 3)
    x = _x(4, 2, 5, cfg.d_model)
    _close(blocks.norm_apply(cfg, _torch(p), torch.from_numpy(x)),
           ref_blocks.norm_apply(rcfg, _jnp(p), jnp.asarray(x)), BLOCK_TOL)


# ---------------------------------------------------------------------------
# blocks and their decode variants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,window", [("qwen1.5-4b", None),
                                         ("gemma3-12b", 8),
                                         ("qwen2.5-32b", None)])
def test_attention_block_and_decode_match_ref(name, window):
    cfg, rcfg = _cfg(name)
    p = _ref_init(ref_blocks.init_attention, rcfg, 5)
    b, s = 2, 12
    x = _x(6, b, s, cfg.d_model)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    want = ref_blocks.apply_attention(rcfg, _jnp(p), jnp.asarray(x),
                                      positions=jnp.asarray(pos),
                                      window=window)
    tp = _torch(p)
    got = blocks.apply_attention(cfg, tp, torch.from_numpy(x),
                                 positions=torch.from_numpy(pos),
                                 window=window)
    _close(got, want, BLOCK_TOL)

    # decode one token at a time; the window ring buffer wraps (smax = 8)
    smax = window or s
    rc = {"k": jnp.zeros((b, cfg.n_kv_heads, smax, cfg.hd)),
          "v": jnp.zeros((b, cfg.n_kv_heads, smax, cfg.hd)),
          "length": jnp.zeros((), jnp.int32)}
    tc = {"k": torch.zeros((b, cfg.n_kv_heads, smax, cfg.hd)),
          "v": torch.zeros((b, cfg.n_kv_heads, smax, cfg.hd)),
          "length": torch.zeros((), dtype=torch.int32)}
    rstep = jax.jit(lambda p_, x_, c_: ref_blocks.apply_attention_decode(
        rcfg, p_, x_, c_, window=window))
    for t in range(s):
        ry, rc = rstep(_jnp(p), jnp.asarray(x[:, t:t + 1]), rc)
        ty, tc = blocks.apply_attention_decode(
            cfg, tp, torch.from_numpy(x[:, t:t + 1]), tc, window=window)
        _close(ty, ry, BLOCK_TOL)
    _close(tc["k"], rc["k"], BLOCK_TOL)
    _close(tc["v"], rc["v"], BLOCK_TOL)
    assert int(tc["length"]) == int(rc["length"]) == s
    spec = blocks.attn_cache_spec(cfg, b, 64, window, torch.float32)
    rspec = ref_blocks.attn_cache_spec(rcfg, b, 64, window)
    assert spec["k"][0] == rspec["k"].shape


@pytest.mark.parametrize("act", ["silu", "geglu", "gelu"])
def test_mlp_matches_ref(act):
    cfg, rcfg = _cfg("qwen1.5-4b", act=act)
    p = _ref_init(ref_blocks.init_mlp, rcfg, 7)
    x = _x(8, 2, 5, cfg.d_model)
    _close(blocks.apply_mlp(cfg, _torch(p), torch.from_numpy(x)),
           ref_blocks.apply_mlp(rcfg, _jnp(p), jnp.asarray(x)), BLOCK_TOL)


def test_causal_conv_matches_ref():
    x, w, state = _x(9, 2, 7, 12), _x(10, 4, 12), _x(11, 2, 3, 12)
    for st in (None, state):
        ry, rs = ref_blocks._causal_conv(
            jnp.asarray(x), jnp.asarray(w),
            None if st is None else jnp.asarray(st))
        ty, ts = blocks._causal_conv(
            torch.from_numpy(x), torch.from_numpy(w),
            None if st is None else torch.from_numpy(st))
        _close(ty, ry, BLOCK_TOL)
        _close(ts, rs, BLOCK_TOL)


@pytest.mark.parametrize("groups", [1, 2])
def test_mamba2_block_and_decode_match_ref(groups):
    cfg, rcfg = _cfg("zamba2-7b", ssm_groups=groups)
    p = _ref_init(ref_blocks.init_mamba2, rcfg, 12)
    b, s = 2, 9
    x = _x(13, b, s, cfg.d_model)
    tp = _torch(p)
    want = ref_blocks.apply_mamba2(rcfg, _jnp(p), jnp.asarray(x))
    got = blocks.apply_mamba2(cfg, tp, torch.from_numpy(x))
    _close(got, want, BLOCK_TOL)

    spec = blocks.mamba_cache_spec(cfg, b, torch.float32)
    rspec = ref_blocks.mamba_cache_spec(rcfg, b)
    assert {k: v[0] for k, v in spec.items()} == \
        {k: v.shape for k, v in rspec.items()}
    rc = {k: jnp.zeros(v.shape, jnp.float32) for k, v in rspec.items()}
    tc = {k: torch.zeros(v[0]) for k, v in spec.items()}
    rstep = jax.jit(lambda p_, x_, c_: ref_blocks.apply_mamba2_decode(
        rcfg, p_, x_, c_))
    for t in range(s):
        ry, rc = rstep(_jnp(p), jnp.asarray(x[:, t:t + 1]), rc)
        ty, tc = blocks.apply_mamba2_decode(
            cfg, tp, torch.from_numpy(x[:, t:t + 1]), tc)
        _close(ty, ry, BLOCK_TOL)
        _close(ty, got[:, t:t + 1].detach(), BLOCK_TOL)
    _close(tc["ssm"], rc["ssm"], BLOCK_TOL)
    _close(tc["conv"], rc["conv"], BLOCK_TOL)


def test_rwkv6_block_and_decode_match_ref():
    cfg, rcfg = _cfg("rwkv6-7b")
    p = _ref_init(ref_blocks.init_rwkv6, rcfg, 14)
    b, s = 2, 9
    x = _x(15, b, s, cfg.d_model)
    tp = _torch(p)
    want = ref_blocks.apply_rwkv6(rcfg, _jnp(p), jnp.asarray(x))
    got = blocks.apply_rwkv6(cfg, tp, torch.from_numpy(x))
    _close(got, want, BLOCK_TOL)

    spec = blocks.rwkv_cache_spec(cfg, b, torch.float32)
    rspec = ref_blocks.rwkv_cache_spec(rcfg, b)
    assert {k: v[0] for k, v in spec.items()} == \
        {k: v.shape for k, v in rspec.items()}
    assert spec["wkv"][1] == torch.float32
    rc = {k: jnp.zeros(v.shape, jnp.float32) for k, v in rspec.items()}
    tc = {k: torch.zeros(v[0]) for k, v in spec.items()}
    rstep = jax.jit(lambda p_, x_, c_: ref_blocks.apply_rwkv6_decode(
        rcfg, p_, x_, c_))
    for t in range(s):
        ry, rc = rstep(_jnp(p), jnp.asarray(x[:, t:t + 1]), rc)
        ty, tc = blocks.apply_rwkv6_decode(
            cfg, tp, torch.from_numpy(x[:, t:t + 1]), tc)
        _close(ty, ry, BLOCK_TOL)
        _close(ty, got[:, t:t + 1], BLOCK_TOL)
    for key in ("last_t", "last_c", "wkv"):
        _close(tc[key], rc[key], BLOCK_TOL)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

MODELS = ["zamba2-7b", "gemma3-12b", "rwkv6-7b"]


def _models(name, seed=0):
    cfg = SMOKE[name]
    ref = ref_build_model(REF_SMOKE[name])
    rparams = _perturb(ref.init(jax.random.PRNGKey(seed))[0], seed)
    port = build_model(cfg)
    return cfg, ref, _jnp(rparams), port, params_from_reference(
        cfg, rparams, device="cpu")


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(
        1, cfg.vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("name", MODELS)
def test_prefill_and_decode_match_ref(name):
    cfg, ref, rp, port, tp = _models(name)
    b, s = 2, 10
    toks = _tokens(cfg, b, s)
    want = jax.jit(ref.prefill)(rp, jnp.asarray(toks))
    got = port.prefill(tp, torch.from_numpy(toks))
    _close(got, want, LOGIT_TOL)

    step = jax.jit(ref.decode_step)
    rc = ref.init_cache(b, 16, dtype=jnp.float32)
    tc = port.init_cache(b, 16, dtype=torch.float32, device="cpu")
    for t in range(s):
        rl, rc = step(rp, rc, jnp.asarray(toks[:, t:t + 1]))
        tl, tc = port.decode_step(tp, tc, torch.from_numpy(toks[:, t:t + 1]))
        _close(tl, rl, LOGIT_TOL)
    # the port's prefill and its teacher-forced decode agree at the end
    _close(tl, got, LOGIT_TOL)
    ref_leaves = jax.tree.leaves(rc)
    port_leaves = jax.tree.leaves(_tree_np(tc))
    assert len(ref_leaves) == len(port_leaves)
    for r_, t_ in zip(ref_leaves, port_leaves):
        assert np.shape(r_) == np.shape(t_)
        _close(t_, r_, LOGIT_TOL)


def _tree_np(tree):
    return jax.tree.map(lambda t: t.numpy(), tree,
                        is_leaf=lambda t: isinstance(t, torch.Tensor))


def test_zamba2_layout_at_full_width():
    model = LM(ARCHS["zamba2-7b"])
    assert (model.repeats, model.tail) == (13, ["mamba"] * 3)
    shapes = model.param_shapes()
    n = sum(t.numel() for t in jax.tree.leaves(
        shapes, is_leaf=lambda t: isinstance(t, torch.Tensor)))
    assert 6.5e9 < n < 7.0e9
    assert tuple(shapes["shared_attn"]["attn"]["wq"].shape) == (3584, 32, 112)
    assert tuple(shapes["units"][0]["w_in"].shape) == (13, 3584, 14576)


def test_rwkv6_layout_at_full_width():
    model = LM(ARCHS["rwkv6-7b"])
    assert (model.unit, model.repeats, model.tail) == (["rwkv"], 32, [])
    shapes = model.param_shapes()
    assert set(shapes) == {"embed", "unembed", "final_norm", "units"}
    n = sum(t.numel() for t in jax.tree.leaves(
        shapes, is_leaf=lambda t: isinstance(t, torch.Tensor)))
    assert n == 7_526_158_336
    layer = shapes["units"][0]
    assert tuple(layer["wr"].shape) == (32, 4096, 4096)
    assert tuple(layer["ck"].shape) == (32, 4096, 14336)
    assert tuple(layer["bonus"].shape) == (32, 64, 64)
    assert tuple(layer["mu"].shape) == (32, 5, 4096)
    specs = model.cache_specs(2, 128, torch.float32)
    assert set(specs) == {"units"}
    assert specs["units"][0]["wkv"] == ((32, 2, 64, 64, 64), torch.float32)


def test_rwkv6_generate_matches_ref():
    cfg, ref, rp, port, tp = _models("rwkv6-7b", seed=5)
    rng = np.random.default_rng(6)
    prompts = [list(rng.integers(1, cfg.vocab, int(rng.integers(3, 8))))
               for _ in range(3)]
    want = RefEngine(ref, rp, RefServeConfig(max_seq=32)).generate(
        prompts, steps=6)
    got = DecodeEngine(port, tp, ServeConfig(max_seq=32),
                       device="cpu").generate(prompts, steps=6)
    assert got.dtype == np.int32 and got.shape == (3, 6)
    assert np.array_equal(got, want)


def test_generate_and_route_match_ref():
    name = "zamba2-7b"
    cfg, ref, rp, port, tp = _models(name, seed=3)
    rng = np.random.default_rng(4)
    prompts = [list(rng.integers(1, cfg.vocab, int(rng.integers(3, 8))))
               for _ in range(3)]
    rreg = RefRegistry(n_machines=3, all_aboard=True)
    treg = PaxosRegistry(n_machines=3, all_aboard=True)
    rengs = [RefEngine(ref, rp, RefServeConfig(max_seq=32), rreg,
                       replica_id=i) for i in range(2)]
    tengs = [DecodeEngine(port, tp, ServeConfig(max_seq=32), treg,
                          replica_id=i, device="cpu") for i in range(2)]
    sessions = [11, 12, 13, 14]
    for s in sessions:
        e = s % 2
        assert tengs[e].route(s) == rengs[e].route(s)
    for s in sessions:                   # sticky across both engines
        assert tengs[0].route(s) == tengs[1].route(s) == rengs[1].route(s)
    want = rengs[0].generate(prompts, steps=6)
    got = tengs[0].generate(prompts, steps=6)
    assert got.dtype == np.int32 and got.shape == (3, 6)
    assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# every architecture of the zoo builds and serves
# ---------------------------------------------------------------------------

def _smoke_inputs(cfg, b, s):
    """Seeded inputs of every kind ``input_specs`` names for a prefill."""
    rng = np.random.default_rng(9)
    out = {}
    for key, (shape, dtype) in input_specs(
            cfg, Shape("smoke", s, b, "prefill"), torch.float32).items():
        if key == "tokens":
            arr = rng.integers(1, cfg.vocab, shape)
        elif key == "mrope_positions":
            arr = np.broadcast_to(np.arange(shape[2]), shape)
        else:
            arr = 0.5 * rng.standard_normal(shape)
        out[key] = torch.from_numpy(np.array(arr)).to(dtype)
    return out


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_every_family_builds_prefills_and_decodes(name):
    cfg = SMOKE[name]
    full = build_model(ARCHS[name]).param_shapes()
    assert all(t.device.type == "meta" for t in jax.tree.leaves(
        full, is_leaf=lambda t: isinstance(t, torch.Tensor)))
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    b, s = 2, 6
    batch = _smoke_inputs(cfg, b, s)
    logits = make_prefill(model)(params, batch)
    assert tuple(logits.shape) == (b, cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    caches = model.init_cache(b, 8, dtype=torch.float32, device="cpu")
    for t in range(2):
        logits, caches = model.decode_step(params, caches,
                                           batch["tokens"][:, t:t + 1])
        assert tuple(logits.shape) == (b, cfg.vocab)
        assert bool(torch.isfinite(logits).all())


def test_params_from_reference_checks_shapes():
    cfg = SMOKE["gemma3-12b"]
    tree = jax.tree.map(np.asarray, ref_build_model(REF_SMOKE["gemma3-12b"])
                        .init(jax.random.PRNGKey(0))[0])
    tree["embed"] = tree["embed"][:, :-1]
    with pytest.raises(ValueError, match="embed"):
        params_from_reference(cfg, tree, device="cpu")
    del tree["embed"]
    with pytest.raises(ValueError, match="keys"):
        params_from_reference(cfg, tree, device="cpu")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; device=None resolves to it")
    model = build_model(SMOKE["zamba2-7b"])
    with pytest.raises(RuntimeError, match="cuda"):
        model.init(0)
    with pytest.raises(RuntimeError, match="cuda"):
        DecodeEngine(model, None, ServeConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(ARCHS["rwkv6-7b"]).init()
    params = model.init(0, device="cpu")
    assert params["embed"].device == CPU
