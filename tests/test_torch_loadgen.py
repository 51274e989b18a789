"""The port's load generator (``repro_torch.serve.loadgen``) against the
reference's: the same seeds give the same Zipf key streams, arrival times,
op draws and sketch quantiles, value for value."""

import random

import numpy as np
import pytest

from repro.core.node import ReqKind as RefReqKind
from repro.serve import loadgen as ref
from repro_torch.core.node import ReqKind
from repro_torch.serve import loadgen as port
from torch_threads import one_thread  # noqa: F401 (autouse)

SEEDS = [0, 1, 7]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n_keys,s,key_base", [(48, 0.9, 0), (1000, 0.99, 1),
                                               (2 ** 20, 0.99, 0),
                                               (97, 0.0, 5)])
def test_zipf_stream_matches_reference(seed, n_keys, s, key_base):
    got = port.ZipfKeys(n_keys, s, seed=seed, key_base=key_base)
    want = ref.ZipfKeys(n_keys, s, seed=seed, key_base=key_base)
    assert got.sample(500) == want.sample(500)
    assert got.hottest(8) == want.hottest(8)
    assert got.stream(3).sample(50) == want.stream(3).sample(50)


@pytest.mark.parametrize("seed", SEEDS)
def test_arrival_times_match_reference(seed):
    phases = [(25.0, 200.0), (0.25, 160.0), (3.0, 40.0)]
    got = port.arrival_times([port.ArrivalPhase(r, t) for r, t in phases],
                             seed)
    want = ref.arrival_times([ref.ArrivalPhase(r, t) for r, t in phases],
                             seed)
    assert got == want and len(got) > 100


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("mix", sorted(ref.MIXES))
def test_op_draws_match_reference(seed, mix):
    rg, rw = random.Random(f"ops:{seed}"), random.Random(f"ops:{seed}")
    got = [port.MIXES[mix].draw(rg) for _ in range(400)]
    want = [ref.MIXES[mix].draw(rw) for _ in range(400)]
    assert [int(k) for k in got] == [int(k) for k in want]
    assert port.MIXES[mix].read == ref.MIXES[mix].read


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("sub_bits", [3, 7])
def test_sketch_quantiles_match_reference(seed, sub_bits):
    rng = np.random.default_rng(seed)
    samples = np.concatenate([rng.exponential(4.0, 3000),
                              rng.uniform(0, 500, 50),
                              [0.0, 0.5, 1e6]])
    got = port.QuantileSketch(sub_bits)
    want = ref.QuantileSketch(sub_bits)
    for v in samples.tolist():
        got.record(v)
        want.record(v)
    for p in (0.01, 0.5, 0.9, 0.99, 0.999, 1.0):
        assert got.quantile(p) == want.quantile(p)
    assert got.summary() == want.summary()
    other_g, other_w = port.QuantileSketch(sub_bits), ref.QuantileSketch(sub_bits)
    other_g.record(7.5, n=9)
    other_w.record(7.5, n=9)
    assert got.merge(other_g).summary() == want.merge(other_w).summary()


@pytest.mark.parametrize("seed", SEEDS)
def test_latency_recorder_matches_reference(seed):
    windows = [(40.0, 95.0), (120.0, 180.0)]
    got, want = port.LatencyRecorder(windows), ref.LatencyRecorder(windows)
    rng = random.Random(seed)
    for _ in range(600):
        kind = rng.choice([0, 1, 2])
        inv = rng.uniform(0, 200)
        done = inv + rng.expovariate(0.2)
        got.observe({"kind": ReqKind(kind), "invoke": inv,
                     "complete": done})
        want.observe({"kind": RefReqKind(kind), "invoke": inv,
                      "complete": done})
    assert got.report() == want.report()
