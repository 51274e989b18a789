"""The zoo's training paths against the JAX reference, on the CPU:
rwkv6-7b, the two MoE models (the load-balance aux term in the loss) and
the encoder-decoder (frames and tokens), at their ``SMOKE`` configs.

Weights come from the reference (perturbed, carried over with
``params_from_reference``), inputs from numpy with a seed.  The reference
runs its jnp paths, whose ``custom_vjp`` backward is the VJP of the same
function the port differentiates (ROADMAP "The reference's condition").
On the CPU the port's float kernels take their plain versions forward and
recompute them backward, as on the card.

Tolerances (float32): loss and grad norm within 1e-5 relative and
parameters within 1e-5 after three steps (``STEP_OPT``'s small learning
rate keeps Adam's division by near-zero gradients under that, see
``tests/test_torch_train.py``); each gradient leaf within 1e-4 of its
largest magnitude; a resumed run's losses within 1e-4 relative.  The last
tests count kimi-k2's one-card cuts on the ``meta`` device.
"""

import dataclasses
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.archs import ARCHS as REF_ARCHS
from repro.configs.archs import SMOKE as REF_SMOKE
from repro.coord.registry import PaxosRegistry as RefRegistry
from repro.data import pipeline as ref_pipeline
from repro.launch import steps as ref_steps
from repro.models.registry import build_model as ref_build_model
from repro.optim import adamw as ref_adamw
from repro.train import loop as ref_loop
from repro_torch.configs.archs import ARCHS, SMOKE
from repro_torch.coord.registry import PaxosRegistry
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import steps
from repro_torch.models.convert import params_from_reference
from repro_torch.models.registry import build_model
from repro_torch.optim import adamw
from repro_torch.serve.paxos import BatchedMachine
from repro_torch.train.loop import TrainConfig, train
from repro_torch.tree import leaves
from test_torch_train import (
    GRAD_TOL, LOSS_TOL, PARAM_TOL, RESUME_TOL, STEP_OPT, _models,
    _port_leaves, _tokens,
)
from torch_threads import one_thread  # noqa: F401 (autouse)

ZOO = ["rwkv6-7b", "mixtral-8x7b", "kimi-k2-1t-a32b", "whisper-large-v3"]
WHISPER = "whisper-large-v3"
KIMI = "kimi-k2-1t-a32b"


def _batch(cfg, b, s, seed):
    """Numpy inputs of one step: tokens, and frames for the
    encoder-decoder."""
    out = {"tokens": _tokens(cfg.vocab, b, s, seed)}
    if cfg.family == "encdec":
        out["frames"] = np.random.default_rng(seed + 100).standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return out


def _close_leaves(cfg, got, want_ref, tol, relative):
    want = _port_leaves(cfg, want_ref)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        bound = tol * float(w.abs().max()) if relative else tol
        assert float((g - w).abs().max()) <= bound


# ---------------------------------------------------------------------------
# make_train_step: three steps against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("name", ZOO)
def test_train_step_matches_ref(name, microbatches):
    cfg, ref, rparams, port = _models(name)
    opt, ropt = adamw.AdamWConfig(**STEP_OPT), \
        ref_adamw.AdamWConfig(**STEP_OPT)
    rstep = jax.jit(ref_steps.make_train_step(ref, ropt,
                                              microbatches=microbatches))
    step = steps.make_train_step(port, opt, microbatches=microbatches)
    rp = jax.tree.map(jnp.asarray, rparams)
    rs = ref_adamw.init(ropt, rp)
    params = params_from_reference(cfg, rparams, device="cpu")
    start = [p.clone() for p in leaves(params)]
    state = adamw.init(opt, params)
    for i in range(3):
        batch = _batch(cfg, 4, 20, seed=30 + i)
        rp, rs, rm = rstep(rp, rs, jax.tree.map(jnp.asarray, batch))
        params, state, m = step(params, state, {
            k: torch.from_numpy(v) for k, v in batch.items()})
        assert abs(float(m["loss"]) / float(rm["loss"]) - 1) <= LOSS_TOL
        assert abs(float(m["grad_norm"]) / float(rm["grad_norm"]) - 1) \
            <= LOSS_TOL
        _close_leaves(cfg, leaves(params), rp, PARAM_TOL, relative=False)
    assert int(state.step) == 3
    moved = max(float((a - b).abs().max())
                for a, b in zip(leaves(params), start))
    assert moved > 10 * PARAM_TOL


# ---------------------------------------------------------------------------
# the encoder-decoder's train_loss gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [True, False])
def test_whisper_train_loss_grads_match_ref(remat):
    cfg, ref, rparams, port = _models(WHISPER)
    batch = _batch(cfg, 2, 12, seed=34)
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p, b: ref.train_loss(p, b, remat=remat)))(
        jax.tree.map(jnp.asarray, rparams), jax.tree.map(jnp.asarray, batch))
    params = params_from_reference(cfg, rparams, device="cpu")
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    loss = port.train_loss(params, {k: torch.from_numpy(v)
                                    for k, v in batch.items()}, remat=remat)
    grads = torch.autograd.grad(loss, ps)
    assert abs(float(loss.detach()) / float(want_loss) - 1) <= LOSS_TOL
    _close_leaves(cfg, grads, want_grads, GRAD_TOL, relative=True)


# ---------------------------------------------------------------------------
# rwkv6's fault-tolerant loop across a restart
# ---------------------------------------------------------------------------

RWKV_DATA = dict(vocab=512, seq_len=32, batch=4, batches_per_shard=2)
RWKV_OPT = dict(STEP_OPT, total_steps=8)
RWKV_RUN = dict(run="w", ckpt_every=2, log_every=1)


@pytest.fixture(scope="module")
def rwkv6_reference_run(tmp_path_factory):
    """The reference trains rwkv6's smoke config 4 steps and commits a
    checkpoint, then continues to step 8 -> (its checkpoint directory,
    committed step, shard cursor at the restart, the continued run, its
    registry)."""
    ckpt = tmp_path_factory.mktemp("rwkv6_ref")
    rmodel = ref_build_model(REF_SMOKE["rwkv6-7b"])
    rreg = RefRegistry(n_machines=3, all_aboard=True)
    rdata = ref_pipeline.DataConfig(**RWKV_DATA)
    ropt = ref_adamw.AdamWConfig(**RWKV_OPT)
    ref_loop.train(rmodel, rdata, ref_loop.TrainConfig(
        steps=4, ckpt_dir=str(ckpt), **RWKV_RUN), ropt, rreg)
    committed, cursor = rreg.latest_checkpoint("w"), \
        rreg.fetch("data/w/cursor")
    want = ref_loop.train(rmodel, rdata, ref_loop.TrainConfig(
        steps=8, ckpt_dir=str(ckpt), **RWKV_RUN), ropt, rreg)
    return ckpt, committed, cursor, want, rreg


@pytest.mark.parametrize("batched", [False, True])
def test_rwkv6_train_resumes_from_the_reference(tmp_path, batched,
                                                rwkv6_reference_run):
    """The port's ``train`` restarts from the reference's step-4
    checkpoint (over a registry with replica 2 crashed) and runs steps
    5-8, against the reference's own continued run: the resume step, the
    shard cursors and the final parameters."""
    ckpt, committed, cursor, want, rreg = rwkv6_reference_run
    assert (committed, cursor) == (4, 2)
    shutil.copytree(ckpt / "w" / "step_00000004",
                    tmp_path / "w" / "step_00000004")
    mcls = functools.partial(BatchedMachine, device="cpu") if batched \
        else None
    reg = PaxosRegistry(n_machines=3, all_aboard=True, machine_cls=mcls)
    assert reg.commit_checkpoint("w", committed)
    assert reg.faa("data/w/cursor", cursor) == 0
    reg.crash(2)
    cfg = SMOKE["rwkv6-7b"]
    got = train(build_model(cfg), DataConfig(**RWKV_DATA),
                TrainConfig(steps=8, ckpt_dir=str(tmp_path), **RWKV_RUN),
                adamw.AdamWConfig(**RWKV_OPT), reg, device="cpu")
    assert got["start_step"] == want["start_step"] == 4
    assert [h["step"] for h in got["history"]] == [5, 6, 7, 8]
    for g, w in zip(got["history"], want["history"]):
        assert abs(g["loss"] / w["loss"] - 1) <= RESUME_TOL
    assert reg.fetch("data/w/cursor") == rreg.fetch("data/w/cursor") == 4
    assert reg.latest_checkpoint("w") == rreg.latest_checkpoint("w") == 8
    _close_leaves(cfg, leaves(got["params"]), want["params"], PARAM_TOL,
                  relative=False)


# ---------------------------------------------------------------------------
# kimi-k2's one-card cuts, counted on meta
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layers,dtype,n_params,gbytes", [
    (1, torch.float32, 19_378_623_488, 77.51),
    (2, torch.bfloat16, 36_408_429_568, 72.82)])
def test_kimi_one_card_cuts(layers, dtype, n_params, gbytes):
    cfg = dataclasses.replace(ARCHS[KIMI], n_layers=layers)
    model = build_model(cfg)
    assert (model.unit, model.repeats, model.tail) == (["moe"], layers, [])
    shapes = leaves(model.param_shapes(dtype))
    assert all(t.device.type == "meta" and t.dtype == dtype for t in shapes)
    n = sum(t.numel() for t in shapes)
    assert n == n_params
    assert round(n * shapes[0].element_size() / 1e9, 2) == gbytes
    # the reference's tree, traced without allocating, has as many
    ref = ref_build_model(dataclasses.replace(REF_ARCHS[KIMI],
                                              n_layers=layers))
    ref_shapes = jax.eval_shape(lambda: ref.init(jax.random.PRNGKey(0))[0])
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(ref_shapes)) \
        == n
