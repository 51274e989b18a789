"""The MoE layer's combine against the reference's scatter-add, and its
determinism on a card.

The reference combines a token's k weighted expert outputs with
``jnp.zeros((t, d), dtype).at[src].add(terms)``, which XLA's CPU scatter
adds one update at a time, in update order, rounding to the dtype after
every add.  The port's ``blocks.combine_in_order`` adds in that order, so
given the same terms it equals the reference bit for bit, in bf16 and in
float32.  The whole bf16 block (routing, capacity dispatch, expert
products, combine) is held to the reference within ``BF16_TOL``: the
products round differently (XLA keeps a fused elementwise chain in
float32).

The reference's tests import JAX in a fixture.  The ``cuda`` test imports
neither JAX nor the reference, so it also runs where PyTorch for CUDA is
all there is::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_moe_combine.py
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs.archs import SMOKE
from repro_torch.models import blocks
from repro_torch.models.common import Init
from torch_threads import one_thread  # noqa: F401 (autouse)

MOE = ["mixtral-8x7b", "kimi-k2-1t-a32b"]
# the bf16 block: max |port - reference| over max |reference|, the float
# kernels' bf16 figure (chip_smoke.FLOAT_TOL); measured 1.32e-02 (mixtral)
# and 6.6e-03 to 8.4e-03 (kimi-k2): 1-2 bf16 ulps of the largest output
BF16_TOL = 2e-2


@pytest.fixture
def ref():
    """The reference's modules (JAX on the CPU)."""
    jax = pytest.importorskip("jax")
    from repro.configs.archs import SMOKE as REF_SMOKE
    from repro.models import blocks as ref_blocks
    from repro.models import common as ref_common
    return types.SimpleNamespace(jax=jax, jnp=jax.numpy, blocks=ref_blocks,
                                 common=ref_common, SMOKE=REF_SMOKE)


def _bits(a):
    """The raw bits of a float32 or bf16 array, as integers."""
    a = np.asarray(a)
    return a.view(np.int16 if a.itemsize == 2 else np.int32)


def _terms(t, k, d, seed):
    """Weighted expert outputs [t*k, d] and their tokens ``src`` [t*k],
    each token k times, in shuffled assignment order."""
    rng = np.random.default_rng(seed)
    src = rng.permutation(np.repeat(np.arange(t), k)).astype(np.int32)
    terms = 4.0 * rng.standard_normal((t * k, d)).astype(np.float32)
    return terms, src


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_combine_equals_reference_scatter_add_bit_for_bit(ref, dtype):
    jnp = ref.jnp
    t, k, d = 300, 8, 128
    terms, src = _terms(t, k, d, seed=31)
    jd = getattr(jnp, dtype)
    want = jnp.zeros((t, d), jd).at[jnp.asarray(src)].add(
        jnp.asarray(terms).astype(jd))
    got = blocks.combine_in_order(
        torch.from_numpy(terms).to(getattr(torch, dtype)),
        torch.from_numpy(src).long(), t, k)
    assert got.dtype == getattr(torch, dtype)
    got_bits = got.view(torch.int16 if dtype == "bfloat16" else torch.int32)
    differ = int((got_bits.numpy() != _bits(want)).sum())
    assert differ == 0, f"{differ} of {t * d} outputs differ"


def test_combine_backward_gathers_each_terms_token_row():
    t, k, d = 50, 4, 16
    terms, src = _terms(t, k, d, seed=32)
    x = torch.from_numpy(terms).requires_grad_()
    up = torch.from_numpy(np.random.default_rng(33).standard_normal(
        (t, d)).astype(np.float32))
    blocks.combine_in_order(x, torch.from_numpy(src).long(), t, k).backward(
        up)
    assert torch.equal(x.grad, up[torch.from_numpy(src).long()])


@pytest.mark.parametrize("name", MOE)
def test_moe_local_compute_bf16_matches_ref(ref, name):
    jax, jnp = ref.jax, ref.jnp
    cfg, rcfg = SMOKE[name], ref.SMOKE[name]
    p, _ = ref.blocks.init_moe(rcfg, ref.common.Init(jax.random.PRNGKey(21)))
    rng = np.random.default_rng(21)
    p = jax.tree.map(lambda a: np.asarray(a, np.float32) + 0.05 *
                     rng.standard_normal(np.shape(a)).astype(np.float32), p)
    x = np.random.default_rng(22).standard_normal(
        (300, cfg.d_model)).astype(np.float32)
    pj = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), p)
    pt = jax.tree.map(lambda a: torch.from_numpy(a).to(torch.bfloat16), p)
    e = cfg.n_experts
    ry, raux = ref.blocks._moe_local_compute(
        rcfg, pj, jnp.asarray(x).astype(jnp.bfloat16), 0, e)
    ty, taux = blocks._moe_local_compute(
        cfg, pt, torch.from_numpy(x).to(torch.bfloat16), 0, e)
    assert ty.dtype == torch.bfloat16
    want = np.asarray(ry.astype(jnp.float32))
    err = float(np.abs(ty.float().numpy() - want).max())
    assert err <= BF16_TOL * float(np.abs(want).max())
    np.testing.assert_allclose(float(taux), float(raux), rtol=1e-5)


@pytest.mark.cuda
def test_kimi_smoke_block_gives_equal_bits_run_after_run():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    cfg = dataclasses.replace(SMOKE["kimi-k2-1t-a32b"], moe_impl="spmd")
    gen = torch.Generator(device=dev).manual_seed(41)
    p = blocks.init_moe(cfg, Init(gen, torch.bfloat16, dev))
    x = torch.randn((2, 512, cfg.d_model), generator=gen, device=dev).to(
        torch.bfloat16)
    assert not torch.are_deterministic_algorithms_enabled()
    y1, _ = blocks.apply_moe_spmd(cfg, p, x)
    y2, _ = blocks.apply_moe_spmd(cfg, p, x)
    assert bool(y1.isfinite().all())
    assert torch.equal(y1.view(torch.int16), y2.view(torch.int16))
