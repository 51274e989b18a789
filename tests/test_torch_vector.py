"""Receiver engine: the port's apply_batch / paxos_apply / replica_step
against the JAX reference's, plane for plane, on the CPU.

Inputs are random KV states and messages over the full receiver
vocabulary (the ranges of tests/test_vector_engine.py), with NOOP lanes
and §8.6 thin commits mixed in; the same numpy planes go through
``repro.core.vector.apply_batch`` / ``repro.kernels.paxos_apply.ops.
replica_step(use_kernel=False)`` and their ``repro_torch`` counterparts.
Tolerance 0: every output plane must be equal and int32 (the mask bool).
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import vector as ref_vector
from repro.core.handlers import Registry
from repro.kernels.paxos_apply import ops as ref_ops
from repro_torch.core import vector
from repro_torch.kernels.paxos_apply import ops
from test_vector_engine import N_SESS, build_batch, random_kv, random_msg
from torch_threads import one_thread  # noqa: F401 (autouse)


def random_planes(seed, n, noop_frac=0.2):
    """Reference (table, batch, is_reg) jnp planes plus the registry:
    random states, random messages, a fraction of lanes NOOP."""
    rng = random.Random(seed)
    kvs = [random_kv(rng, i) for i in range(n)]
    msgs = [random_msg(rng, i) for i in range(n)]
    registry = Registry(N_SESS)
    for s in range(N_SESS):
        registry.committed[s] = rng.randint(0, 3)
    table, batch, is_reg = build_batch(kvs, msgs, registry)
    noop = np.random.default_rng(seed).random(n) < noop_frac
    kind = np.where(noop, ref_vector.NOOP, np.asarray(batch.kind))
    batch = batch._replace(kind=jnp.asarray(kind, jnp.int32))
    return table, batch, is_reg, registry


def _np(x):
    return np.asarray(x)


def assert_planes_equal(names, got, want, what):
    for f, a, b in zip(names, got, want):
        assert a.dtype == torch.int32, f"{what} {f} dtype {a.dtype}"
        np.testing.assert_array_equal(a.numpy(), _np(b),
                                      err_msg=f"{what} field {f}")


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 7), (2, 300), (3, 2000),
                                    (4, 4096)])
def test_apply_batch_matches_reference(seed, n):
    table, batch, is_reg, _ = random_planes(seed, n)
    want_kv, want_rep, want_mask = ref_vector.apply_batch(table, batch,
                                                          is_reg)
    got_kv, got_rep, got_mask = vector.apply_batch(
        vector.KVTable.from_numpy(table, device="cpu"),
        vector.MsgBatch.from_numpy(batch, device="cpu"),
        torch.from_numpy(np.array(is_reg)))
    assert_planes_equal(vector.KVTable._fields, got_kv, want_kv, "kv")
    assert_planes_equal(vector.ReplyBatch._fields, got_rep, want_rep, "reply")
    assert got_mask.dtype == torch.bool
    np.testing.assert_array_equal(got_mask.numpy(), _np(want_mask))


@pytest.mark.parametrize("seed,n", [(5, 127), (6, 5000)])
def test_packed_wrapper_on_cpu_is_the_plain_version(seed, n):
    """paxos_apply on CPU tensors takes the plain version, over the packed
    (18, n) / (12, n) stacks the fused engine hands it."""
    table, batch, is_reg, _ = random_planes(seed, n)
    want_kv, want_rep, want_mask = ref_vector.apply_batch(table, batch,
                                                          is_reg)
    kv = torch.from_numpy(np.stack([_np(p) for p in table]))
    msgreg = torch.from_numpy(np.concatenate(
        [np.stack([_np(p) for p in batch]),
         _np(is_reg).astype(np.int32)[None]]))
    before = ops.paxos_apply.launches
    out = (torch.empty_like(kv), torch.empty((11, n), dtype=torch.int32),
           torch.empty(n, dtype=torch.int32))
    got_kv, got_rep, got_mask = ops.paxos_apply(kv, msgreg, out=out)
    assert ops.paxos_apply.launches == before     # no kernel on the CPU
    assert got_kv is out[0] and got_mask is out[2]
    np.testing.assert_array_equal(got_kv.numpy(),
                                  np.stack([_np(p) for p in want_kv]))
    np.testing.assert_array_equal(got_rep.numpy(),
                                  np.stack([_np(p) for p in want_rep]))
    np.testing.assert_array_equal(got_mask.numpy(),
                                  _np(want_mask).astype(np.int32))


@pytest.mark.parametrize("seed,n", [(7, 100), (8, 1000), (9, 5000)])
def test_replica_step_matches_reference(seed, n):
    table, batch, _, registry = random_planes(seed, n)
    reg = np.array(registry.committed, np.int32)
    want_kv, want_rep, want_reg = ref_ops.replica_step(
        table, batch, jnp.asarray(reg), use_kernel=False)
    got_kv, got_rep, got_reg = ops.replica_step(
        vector.KVTable.from_numpy(table, device="cpu"),
        vector.MsgBatch.from_numpy(batch, device="cpu"),
        torch.from_numpy(reg.copy()))
    assert_planes_equal(vector.KVTable._fields, got_kv, want_kv, "kv")
    assert_planes_equal(vector.ReplyBatch._fields, got_rep, want_rep, "reply")
    np.testing.assert_array_equal(got_reg.numpy(), _np(want_reg))
    assert (got_reg.numpy() >= reg).all()


def test_scatter_register_masked_lanes_hit_dead_slot():
    """Masked-out lanes (and sessions outside the table) must not alias
    live session 0 — same cases as the reference's dead-slot test."""
    n = 8
    registered = torch.tensor([-5, 2, 7], dtype=torch.int32)
    msg = vector.MsgBatch.noop(n, device="cpu")._replace(
        rmw_sess=torch.zeros(n, dtype=torch.int32),
        rmw_cnt=torch.full((n,), -1, dtype=torch.int32))
    mask = torch.zeros(n, dtype=torch.bool)
    want = ref_ops.scatter_register(
        jnp.asarray([-5, 2, 7], jnp.int32),
        ref_vector.MsgBatch(*[jnp.asarray(p.numpy()) for p in msg]),
        jnp.zeros((n,), bool))
    out = ops.scatter_register(registered, msg, mask)
    np.testing.assert_array_equal(out.numpy(), _np(want))
    np.testing.assert_array_equal(out.numpy(), [-5, 2, 7])
    mask[3] = True
    msg.rmw_sess[3] = 1
    msg.rmw_cnt[3] = 9
    mask[5] = True
    msg.rmw_sess[5] = 3                  # one past the table: dropped
    msg.rmw_cnt[5] = 99
    out = ops.scatter_register(registered, msg, mask)
    np.testing.assert_array_equal(out.numpy(), [-5, 9, 7])


def test_lane_contract_valueerrors():
    n = 100
    table = vector.KVTable.create(n, device="cpu")
    batch = vector.MsgBatch.noop(n, device="cpu")
    bad = batch._replace(kind=torch.zeros(n + 1, dtype=torch.int32))
    with pytest.raises(ValueError, match="(?i)padding contract"):
        ops.replica_step(table, bad, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="registered"):
        ops.replica_step(table, batch, torch.zeros((2, 2), dtype=torch.int32))
    # the reference raises the same texts
    ref_bad = ref_vector.MsgBatch.noop(n)._replace(
        kind=jnp.zeros((n + 1,), jnp.int32))
    with pytest.raises(ValueError, match="(?i)padding contract"):
        ref_ops.replica_step(ref_vector.KVTable.create(n), ref_bad,
                             jnp.zeros((4,), jnp.int32), use_kernel=False)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    n = 16
    kv = torch.zeros((18, n), dtype=torch.int32)
    msgreg = torch.zeros((12, n), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        ops.paxos_apply(kv.long(), msgreg)
    with pytest.raises(ValueError, match="shape"):
        ops.paxos_apply(kv, msgreg[:11])
    with pytest.raises(ValueError, match="contiguous"):
        ops.paxos_apply(torch.zeros((n, 18), dtype=torch.int32).T, msgreg)
    out = (kv, torch.empty((11, n), dtype=torch.int32),
           torch.empty(n, dtype=torch.int32))
    with pytest.raises(ValueError, match="aliases"):
        ops.paxos_apply(kv, msgreg, out=out)


def test_noop_lanes_untouched():
    n = 4096
    table = vector.KVTable.create(n, device="cpu")._replace(
        value=torch.arange(n, dtype=torch.int32))
    batch = vector.MsgBatch.noop(n, device="cpu")
    new_kv, replies, mask = vector.apply_batch(
        table, batch, torch.zeros(n, dtype=torch.bool))
    np.testing.assert_array_equal(new_kv.value.numpy(), np.arange(n))
    assert (replies.opcode.numpy() == -1).all()
    assert not mask.any()


def test_fresh_table_matches_reference():
    ref = ref_vector.KVTable.fresh(5)
    got = vector.KVTable.fresh(5, device="cpu")
    assert_planes_equal(vector.KVTable._fields, got, ref, "fresh")
