"""The port's training path against the JAX reference, on the CPU.

Weights are drawn by the reference, perturbed with numpy noise (as
``tests/test_torch_lm.py`` does) and carried over with
``params_from_reference``; tokens are numpy draws from a seed.  The
reference runs its jnp paths (``impl="xla"``): its ``custom_vjp``
backward is that path's VJP, so both packages differentiate the same
function (a gradient through the reference's Pallas path fails on JAX
0.9.0, ROADMAP "Where we are").  On the CPU the port's float kernels take
their plain versions forward and recompute them backward, as on the card.

Tolerances (float32): a loss within 1e-5 relative; each gradient leaf
within 1e-4 of its largest magnitude; parameters after three steps within
1e-5; a continued run's losses within 1e-4 relative.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as ref_store
from repro.configs.archs import SMOKE as REF_SMOKE
from repro.coord.registry import PaxosRegistry as RefRegistry
from repro.data import pipeline as ref_pipeline
from repro.launch import steps as ref_steps
from repro.models.config import ModelConfig as RefModelConfig
from repro.models.registry import build_model as ref_build_model
from repro.optim import adamw as ref_adamw
from repro.train import loop as ref_loop
from repro_torch.checkpoint import store
from repro_torch.configs.archs import SMOKE
from repro_torch.coord.registry import PaxosRegistry
from repro_torch.data.pipeline import DataConfig, ShardedStream, synth_batch
from repro_torch.launch import steps
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_reference
from repro_torch.models.registry import build_model
from repro_torch.optim import adamw
from repro_torch.serve.paxos import BatchedMachine
from repro_torch.train.loop import TrainConfig, train
from repro_torch.tree import leaves

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 1e-5
RESUME_TOL = 1e-4
MODELS = ["zamba2-7b", "rwkv6-7b", "gemma3-12b", "qwen2.5-32b"]


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32), tree)


def _models(name, seed=0):
    cfg = SMOKE[name]
    ref = ref_build_model(REF_SMOKE[name])
    rparams = _perturb(ref.init(jax.random.PRNGKey(seed))[0], seed)
    return cfg, ref, rparams, build_model(cfg)


def _tokens(vocab, b, s, seed):
    return np.random.default_rng(seed).integers(1, vocab, (b, s)).astype(
        np.int32)


def _port_leaves(cfg, ref_tree):
    """A reference parameter-shaped tree as the port's leaves, in order."""
    return leaves(params_from_reference(
        cfg, jax.tree.map(np.asarray, ref_tree), device="cpu"))


# ---------------------------------------------------------------------------
# LM.train_loss and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("name", MODELS)
def test_train_loss_and_grads_match_ref(name, remat):
    cfg, ref, rparams, port = _models(name)
    # 72 tokens: past gemma3's smoke window (64), and zamba2's smoke tail
    toks = _tokens(cfg.vocab, 2, 72, seed=1)
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p, t: ref.train_loss(p, {"tokens": t}, remat=remat)))(
        jax.tree.map(jnp.asarray, rparams), jnp.asarray(toks))
    params = params_from_reference(cfg, rparams, device="cpu")
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    loss = port.train_loss(params, {"tokens": torch.from_numpy(toks)},
                           remat=remat)
    grads = torch.autograd.grad(loss, ps)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(float(loss.detach()) / float(want_loss) - 1) <= LOSS_TOL
    want = _port_leaves(cfg, want_grads)
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= GRAD_TOL * float(w.abs().max())


def test_train_loss_rejects_vlm_inputs():
    """VLM inputs are taken as the reference takes them (its gradients
    too); M-RoPE streams that do not cover the vision tokens are refused
    in both packages."""
    cfg, ref, rparams, port = _models("qwen2-vl-72b")
    params = params_from_reference(cfg, rparams, device="cpu")
    rng = np.random.default_rng(2)
    toks = _tokens(cfg.vocab, 2, 8, seed=2)
    vis = rng.standard_normal((2, 4, cfg.d_model)).astype(np.float32)
    pos = np.stack([np.zeros((2, 12)), np.tile(np.arange(12) % 3, (2, 1)),
                    np.tile(np.arange(12), (2, 1))]).astype(np.int32)
    batch = {"tokens": toks, "vision_embeds": vis, "mrope_positions": pos}
    want_loss, want_grads = jax.jit(jax.value_and_grad(ref.train_loss))(
        jax.tree.map(jnp.asarray, rparams),
        jax.tree.map(jnp.asarray, batch))
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    loss = port.train_loss(params, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    grads = torch.autograd.grad(loss, ps)
    for p in ps:
        p.requires_grad_(False)
    assert abs(float(loss.detach()) / float(want_loss) - 1) <= LOSS_TOL
    for g, w in zip(grads, _port_leaves(cfg, want_grads)):
        assert float((g - w).abs().max()) <= GRAD_TOL * float(w.abs().max())
    short = dict(batch, mrope_positions=pos[:, :, 4:])
    with pytest.raises(TypeError):
        jax.jit(ref.train_loss)(jax.tree.map(jnp.asarray, rparams),
                                jax.tree.map(jnp.asarray, short))
    with pytest.raises(RuntimeError):
        port.train_loss(params, {k: torch.from_numpy(v)
                                 for k, v in short.items()})


# ---------------------------------------------------------------------------
# make_train_step
# ---------------------------------------------------------------------------

# Adam's first steps divide each gradient element by its own magnitude plus
# eps (1e-8).  An element whose gradient is near 0 differs between the
# packages by float32 noise of about 1e-8, which moves its update by up to
# 0.13 lr (measured on qwen2.5's smoke config); lr 5e-5 keeps that under
# PARAM_TOL while each step still moves the parameters by up to 5e-5.
STEP_OPT = dict(lr=5e-5, warmup_steps=1, total_steps=10)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("name", ["zamba2-7b", "qwen2.5-32b"])
def test_train_step_matches_ref(name, microbatches):
    cfg, ref, rparams, port = _models(name)
    rstep = jax.jit(ref_steps.make_train_step(
        ref, ref_adamw.AdamWConfig(**STEP_OPT), microbatches=microbatches))
    step = steps.make_train_step(port, adamw.AdamWConfig(**STEP_OPT),
                                 microbatches=microbatches)
    rp = jax.tree.map(jnp.asarray, rparams)
    rs = ref_adamw.init(ref_adamw.AdamWConfig(**STEP_OPT), rp)
    params = params_from_reference(cfg, rparams, device="cpu")
    start = [p.clone() for p in leaves(params)]
    state = adamw.init(adamw.AdamWConfig(**STEP_OPT), params)
    for i in range(3):
        toks = _tokens(cfg.vocab, 4, 24, seed=10 + i)
        rp, rs, rm = rstep(rp, rs, {"tokens": jnp.asarray(toks)})
        params, state, m = step(params, state,
                                {"tokens": torch.from_numpy(toks)})
        assert abs(float(m["loss"]) / float(rm["loss"]) - 1) <= LOSS_TOL
        assert abs(float(m["grad_norm"]) / float(rm["grad_norm"]) - 1) \
            <= LOSS_TOL
        for got, want in zip(leaves(params), _port_leaves(cfg, rp)):
            assert float((got - want).abs().max()) <= PARAM_TOL
    assert int(state.step) == 3
    assert not any(p.requires_grad for p in leaves(params))
    moved = max(float((a - b).abs().max())
                for a, b in zip(leaves(params), start))
    assert moved > 10 * PARAM_TOL


def test_prefill_and_decode_steps():
    cfg, ref, rparams, port = _models("zamba2-7b")
    params = params_from_reference(cfg, rparams, device="cpu")
    toks = torch.from_numpy(_tokens(cfg.vocab, 2, 6, seed=3))
    logits = steps.make_prefill(port)(params, {"tokens": toks})
    caches = port.init_cache(2, 8, dtype=torch.float32, device="cpu")
    decode = steps.make_decode_step(port)
    for t in range(6):
        last, caches = decode(params, caches, {"tokens": toks[:, t:t + 1]})
    torch.testing.assert_close(last, logits, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# data: synth_batch and the leased stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(vocab=32000, seq_len=64,
                                             batch=2, seed=7)])
def test_synth_batch_bit_equal(kw):
    cfg, rcfg = DataConfig(**kw), ref_pipeline.DataConfig(**kw)
    for shard, index in [(0, 0), (3, 1), (17, 3), (2 ** 20, 0)]:
        got = synth_batch(cfg, shard, index)
        want = ref_pipeline.synth_batch(rcfg, shard, index)
        assert got.dtype == want.dtype == np.int32
        assert np.array_equal(got, want)


@pytest.mark.parametrize("batched", [False, True])
def test_sharded_stream_cursors_match_ref(batched):
    kw = dict(vocab=256, seq_len=16, batch=2, batches_per_shard=3)
    cfg, rcfg = DataConfig(**kw), ref_pipeline.DataConfig(**kw)
    mcls = functools.partial(BatchedMachine, device="cpu") if batched \
        else None
    reg = PaxosRegistry(n_machines=3, all_aboard=True, machine_cls=mcls)
    rreg = RefRegistry(n_machines=3, all_aboard=True)
    got = [iter(ShardedStream(cfg, reg, "r", device="cpu"))
           for _ in range(2)]
    want = [iter(ref_pipeline.ShardedStream(rcfg, rreg, "r"))
            for _ in range(2)]
    for _ in range(4):           # two trainers interleaved, 4 batches each
        for g, w in zip(got, want):
            tb, rb = next(g), next(w)
            assert tb.dtype == torch.int32 and tb.device.type == "cpu"
            assert np.array_equal(tb.numpy(), np.asarray(rb))
    assert reg.fetch("data/r/cursor") == rreg.fetch("data/r/cursor") == 4
    local = iter(ShardedStream(cfg, None, device="cpu"))
    assert np.array_equal(next(local).numpy(), synth_batch(cfg, 0, 0))


# ---------------------------------------------------------------------------
# the training loop
# ---------------------------------------------------------------------------

TINY = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=2,
            n_kv_heads=2, d_ff=128, vocab=256)
TINY_DATA = dict(vocab=256, seq_len=32, batch=4, batches_per_shard=2)


def test_train_restart_resumes_and_descends(tmp_path):
    model = build_model(ModelConfig(**TINY))
    data = DataConfig(**TINY_DATA)
    opt = adamw.AdamWConfig(lr=2e-3, total_steps=16, warmup_steps=2)
    reg = PaxosRegistry(n_machines=3, all_aboard=True)
    logs, ckpts, epochs = [], [], []
    hooks = {"on_log": logs.append,
             "on_ckpt": lambda s, won: ckpts.append((s, won)),
             "on_membership": epochs.append}
    t1 = TrainConfig(run="t", steps=8, ckpt_every=4, ckpt_dir=str(tmp_path),
                     log_every=1)
    out1 = train(model, data, t1, opt, reg, hooks, device="cpu")
    assert out1["start_step"] == 0 and reg.latest_checkpoint("t") == 8
    reg.crash(2)                           # a minority replica down
    reg.join_membership("t", 1)
    t2 = dataclasses.replace(t1, steps=16)
    out2 = train(model, data, t2, opt, reg, hooks, device="cpu")
    assert out2["start_step"] == 8
    assert reg.latest_checkpoint("t") == 16
    assert ckpts == [(4, True), (8, True), (12, True), (16, True)]
    assert [h["step"] for h in logs] == list(range(1, 17))
    assert epochs == []            # the epoch changed between the runs
    # exactly-once data: 16 steps of 2 batches a shard took 8 leases
    assert reg.fetch("data/t/cursor") == 8
    losses = [h["loss"] for h in logs]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-2:]) < np.mean(losses[:2])
    assert set(out2) == {"params", "opt_state", "history", "wall_s",
                         "start_step"}
    # the state restored at step 8 is the state saved there, bit for bit
    saved, step = store.restore(str(tmp_path), "t",
                                (out1["params"], out1["opt_state"]), step=8)
    assert step == 8
    for a, b in zip(leaves(saved), leaves((out1["params"],
                                           out1["opt_state"]))):
        assert torch.equal(a, b)


def test_membership_hook_sees_a_change(tmp_path):
    model = build_model(ModelConfig(**TINY))
    reg = PaxosRegistry(n_machines=3, all_aboard=True)
    epochs = []

    def on_ckpt(step, won):
        reg.join_membership("m", step)

    train(model, DataConfig(**TINY_DATA),
          TrainConfig(run="m", steps=4, ckpt_every=2, ckpt_dir=str(tmp_path),
                      log_every=4),
          registry=reg, device="cpu",
          hooks={"on_ckpt": on_ckpt, "on_membership": epochs.append})
    assert epochs == [1 << 2, (1 << 2) | (1 << 4)]


def test_resume_from_a_reference_checkpoint(tmp_path):
    """The reference trains 4 steps and commits a checkpoint; the port
    restores that file and runs steps 5-8, against the reference's own
    continued run."""
    data_kw = dict(TINY_DATA)
    opt_kw = dict(lr=2e-3, total_steps=8, warmup_steps=2)
    rmodel = ref_build_model(RefModelConfig(**TINY))
    rreg = RefRegistry(n_machines=3, all_aboard=True)
    rdata = ref_pipeline.DataConfig(**data_kw)
    ropt = ref_adamw.AdamWConfig(**opt_kw)
    tcfg = dict(run="x", ckpt_every=4, ckpt_dir=str(tmp_path), log_every=1)
    ref_loop.train(rmodel, rdata, ref_loop.TrainConfig(steps=4, **tcfg),
                   ropt, rreg)
    committed = rreg.latest_checkpoint("x")
    cursor = rreg.fetch("data/x/cursor")
    assert (committed, cursor) == (4, 2)
    want = ref_loop.train(rmodel, rdata, ref_loop.TrainConfig(steps=8, **tcfg),
                          ropt, rreg)

    reg = PaxosRegistry(n_machines=3, all_aboard=True)
    assert reg.commit_checkpoint("x", committed)
    assert reg.faa("data/x/cursor", cursor) == 0
    got = train(build_model(ModelConfig(**TINY)), DataConfig(**data_kw),
                TrainConfig(steps=8, **tcfg), adamw.AdamWConfig(**opt_kw),
                reg, device="cpu")
    assert got["start_step"] == want["start_step"] == 4
    assert [h["step"] for h in got["history"]] == [5, 6, 7, 8]
    for g, w in zip(got["history"], want["history"]):
        assert g["step"] == w["step"]
        assert abs(g["loss"] / w["loss"] - 1) <= RESUME_TOL
    assert reg.fetch("data/x/cursor") == rreg.fetch("data/x/cursor") == 4
    # the port's step-8 checkpoint has the reference's keys, leaf for leaf
    with np.load(tmp_path / "x" / "step_00000008" / "shards.npz") as f:
        port_keys = sorted(f.files)
    assert port_keys == sorted(ref_store._flatten(
        (want["params"], want["opt_state"])))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; device=None resolves to it")
    cfg = DataConfig(**TINY_DATA)
    with pytest.raises(RuntimeError, match="cuda"):
        ShardedStream(cfg, None)
    with pytest.raises(RuntimeError, match="cuda"):
        train(build_model(ModelConfig(**TINY)), cfg, TrainConfig(steps=1))
