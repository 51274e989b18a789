#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout, on a machine with one CUDA card::

    python3 chip_smoke.py

Phases (any failure exits nonzero and prints no result):

1. **Build** the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
   call) and print the build time, ptxas' register/spill report and the
   card's name and power limit.
2. **Kernel vs plain** on random planes made from a seed on the card:
   ``paxos_apply`` at 5 x 2^20 lanes and at ragged lane counts,
   ``paxos_propose`` at 5 x 800 lanes and ragged counts, idle lanes and
   mixed per-machine quorum parameters.  Every output plane must equal the
   plain PyTorch version run on the card (0 mismatches).
3. **Full-width serve**: ``Cluster(machine_cls=BatchedMachine)`` on the
   card at 5 replicas x 800 sessions x 2^20 key lanes, the kv_mixed
   10/20/70 rmw/write/read mix over 2^20 keys, batched-smoke network
   faults; one plain seed and one all-aboard seed with a crash/restart of
   machine 4 mid-run.  Completions must equal the port's scalar cluster
   on the same seed, the safety checkers must be green, both kernels must
   have launched, and a sample of the fused calls is replayed through the
   plain versions on the card.
4. **Timings** of each kernel at the main path's shapes (CUDA events,
   median after warm-up), its bound and its plain version's time.

The last three lines of standard output are the ``nvidia-smi`` name and
power limit, one JSON object describing the kernels, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import functools
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate, and the int32 rate of the
# CUDA cores (64 INT32 lanes per SM x 132 SMs x 1.98 GHz boost).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# integer operations per lane of each select network, counted from the
# straight-line CUDA source (compares, logic, selects, address math)
APPLY_OPS_PER_LANE = 260
PROPOSE_OPS_PER_LANE = 520

M, SESSIONS, KEYS = 5, 800, 2 ** 20
N_OPS = 4000


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# random planes on the card
# ---------------------------------------------------------------------------

def _randint(torch, g, lo, hi, shape, dev):
    return torch.randint(lo, hi, shape, generator=g, device=dev,
                         dtype=torch.int32)


def apply_inputs(torch, n, seed, dev):
    """(18, n) KV and (12, n) message+registry planes in small ranges so
    every branch of the receiver network is taken."""
    g = torch.Generator(device=dev).manual_seed(seed)
    kv = _randint(torch, g, -1, 7, (18, n), dev)
    kv[0] = _randint(torch, g, 0, 3, (n,), dev)            # state
    msgreg = _randint(torch, g, -1, 8, (12, n), dev)
    msgreg[0] = _randint(torch, g, 0, 8, (n,), dev)        # kind, 0 = NOOP
    msgreg[10] = _randint(torch, g, 0, 2, (n,), dev)       # has_value
    msgreg[11] = _randint(torch, g, 0, 2, (n,), dev)       # is_registered
    return kv, msgreg


def propose_inputs(torch, pv, m, s, seed, dev):
    """(65, n) tables, (13, n) steered replies (a third idle) and a (4, m)
    block of mixed per-machine quorum parameters."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n = m * s
    idx = {f: i for i, f in enumerate(pv.ProposerTable._fields)}
    tab = _randint(torch, g, -1, 5, (65, n), dev)
    tab[idx["phase"]] = _randint(torch, g, 0, 5, (n,), dev)
    abd = _randint(torch, g, 0, 6, (n,), dev)
    tab[idx["abd_phase"]] = torch.where(abd == 5, 9, abd)
    for f in ("lid", "abd_lid"):
        tab[idx[f]] = _randint(torch, g, 0, 2, (n,), dev)
    for f in ("rep_bits", "ack_bits", "abd_rep_bits", "abd_ack_bits",
              "abd_store_bits"):
        tab[idx[f]] = _randint(torch, g, 0, 256, (n,), dev)
    tab[idx["lth_counter"]][::7] = 2 ** 31 - 1               # wraps on +1
    kinds = torch.tensor([-1, -1, -1, 3, 4, 5, 7, 9, 11], dtype=torch.int32,
                         device=dev)
    rep = _randint(torch, g, -1, 6, (13, n), dev)
    rep[0] = kinds[_randint(torch, g, 0, len(kinds), (n,), dev).long()]
    rep[1] = _randint(torch, g, 0, 12, (n,), dev)            # opcode
    rep[2] = _randint(torch, g, -1, 9, (n,), dev)            # src
    rep[3] = _randint(torch, g, 0, 2, (n,), dev)             # lid
    n_machines = torch.tensor([3, 5, 7], dtype=torch.int32, device=dev)[
        _randint(torch, g, 0, 3, (m,), dev).long()]
    majority = n_machines // 2 + 1
    commit_need = torch.where(_randint(torch, g, 0, 2, (m,), dev) == 0, 1,
                              majority - 1).to(torch.int32)
    lth = _randint(torch, g, 1, 5, (m,), dev)
    params = torch.stack([n_machines, majority, commit_need, lth]).to(
        torch.int32).contiguous()
    return tab, rep, params


class Agreement:
    """Accumulated kernel-vs-plain comparison of one kernel."""

    def __init__(self):
        self.mismatches = 0
        self.max_abs_err = 0
        self.compared = 0

    def add(self, torch, got, want, what):
        for a, b in zip(got, want):
            diff = (a.long() - b.long()).abs()
            self.mismatches += int((diff != 0).sum())
            self.max_abs_err = max(self.max_abs_err, int(diff.max()))
            self.compared += a.numel()
        if self.mismatches:
            raise AssertionError(f"{what}: {self.mismatches} elements "
                                 f"differ from the plain version")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build(build):
    lib = build.build()
    log(f"[build] nvcc {lib.build_seconds:.2f} s -> "
        f"{lib.path.relative_to(ROOT)}")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")
    return lib


def phase_kernels(torch, apply_ops, propose_ops, pv, dev):
    apply_ok, propose_ok = Agreement(), Agreement()
    for i, n in enumerate((M * KEYS, 1, 127, 5000, 12289)):
        kv, msgreg = apply_inputs(torch, n, 100 + i, dev)
        got = apply_ops.paxos_apply(kv, msgreg)
        want = apply_ops.paxos_apply_plain(kv, msgreg)
        torch.cuda.synchronize()
        apply_ok.add(torch, got, want, f"paxos_apply n={n}")
        log(f"[kernels] paxos_apply n={n}: 0 mismatches over "
            f"{sum(t.numel() for t in got)} outputs")
    for i, (m, s) in enumerate(((M, SESSIONS), (1, 1), (1, 127),
                                (3, 1667), (12289, 1))):
        tab, rep, params = propose_inputs(torch, pv, m, s, 200 + i, dev)
        got = propose_ops.paxos_propose(tab, rep, params, s)
        want = propose_ops.paxos_propose_plain(tab, rep, params, s)
        torch.cuda.synchronize()
        propose_ok.add(torch, got, want, f"paxos_propose {m}x{s}")
        decisions = torch.unique(got[1][0]).numel()
        log(f"[kernels] paxos_propose {m}x{s}: 0 mismatches over "
            f"{sum(t.numel() for t in got)} outputs, {decisions} distinct "
            f"decisions")
    return apply_ok, propose_ok


def _make_cluster(mods, machine_cls, seed, aboard, n_ops):
    cfg = mods.ProtocolConfig(n_machines=M, sessions_per_machine=SESSIONS,
                              all_aboard=aboard)
    net = mods.NetConfig(seed=seed, drop_prob=0.06, dup_prob=0.05,
                         heavy_tail_prob=0.03, heavy_tail_extra=25.0)
    cl = mods.Cluster(cfg, net, machine_cls=machine_cls)
    mods.workload(cl, n_ops=n_ops, keys=KEYS, seed=seed, rmw_frac=0.1,
                  write_frac=0.2)
    return cl


def _serve_cluster(mods, machine_cls, seed, aboard, crash, n_ops):
    t0 = time.perf_counter()
    cl = _make_cluster(mods, machine_cls, seed, aboard, n_ops)
    if crash:
        cl.step(8)
        cl.network.deliver_due(cl.network.now + 1.0, cl.machines)
        cl.crash(4)
        cl.step(6)
        cl.restart(4)
    if not cl.run_until_quiet(max_ticks=120_000):
        raise RuntimeError(f"seed {seed}: cluster did not quiesce")
    return cl, time.perf_counter() - t0


class Recorder:
    """Clones the inputs and outputs of a few fused calls on the card."""

    def __init__(self, torch, fn, keep):
        self.torch, self.fn, self.keep = torch, fn, set(keep)
        self.calls = 0
        self.samples = []

    def __call__(self, *args, **kw):
        i = self.calls
        self.calls += 1
        if i not in self.keep:
            return self.fn(*args, **kw)
        ins = [a.clone() for a in args]
        outs = self.fn(*args, **kw)
        self.samples.append((i, ins, [o.clone() for o in outs]))
        return outs


def phase_serve(torch, mods, dev, n_ops):
    ce = mods.cluster_engine
    rec_r = Recorder(torch, ce._fused_receiver_step, (0, 7, 70, 400))
    rec_i = Recorder(torch, ce._fused_issuer_step, (0, 7, 70, 400))
    batched_cls = functools.partial(mods.BatchedMachine, device=dev)
    runs = []
    # the main path: counts start at 0 here and are read right after
    mods.apply_ops.paxos_apply.launches = 0
    mods.propose_ops.paxos_propose.launches = 0
    ce._fused_receiver_step, ce._fused_issuer_step = rec_r, rec_i
    try:
        for seed, aboard, crash in ((0, False, False), (1, True, True)):
            torch.cuda.synchronize()
            batched, t_b = _serve_cluster(mods, batched_cls, seed, aboard,
                                          crash, n_ops)
            torch.cuda.synchronize()
            runs.append((seed, aboard, crash, batched, t_b))
    finally:
        ce._fused_receiver_step = rec_r.fn
        ce._fused_issuer_step = rec_i.fn
    launches = {"paxos_apply": mods.apply_ops.paxos_apply.launches,
                "paxos_propose": mods.propose_ops.paxos_propose.launches}
    log(f"[serve] main-path launches: {json.dumps(launches)}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} never launched on the main path")

    waves_all = 0
    for seed, aboard, crash, batched, t_b in runs:
        scalar, t_s = _serve_cluster(mods, mods.Machine, seed, aboard,
                                     crash, n_ops)
        got = mods.completion_tuples(batched)
        want = mods.completion_tuples(scalar)
        if got != want:
            first = next((a, b) for a, b in zip(got, want) if a != b) \
                if len(got) == len(want) else (len(got), len(want))
            raise AssertionError(f"seed {seed}: batched completions differ "
                                 f"from scalar: {first}")
        t0 = time.perf_counter()
        mods.checkers.check_all(batched)
        t_chk = time.perf_counter() - t0
        eng = batched.engine
        for stack in (eng.kv, eng.tab):
            if stack.dev.device != dev:
                raise AssertionError(f"a plane stack is on {stack.dev.device}"
                                     f", not on {dev}")
        tel = eng.telemetry()
        waves = tel["waves"]
        waves_all += waves
        kv_shape = tuple(eng.kv.dev.shape)
        log(f"[serve] seed {seed} ({'all-aboard + crash/restart m4' if crash else 'plain'}): "
            f"{len(got)} completions identical to scalar, checkers green "
            f"({t_chk:.2f} s); KV stack {kv_shape} "
            f"({eng.kv.dev.numel() * 4 / 1e9:.3f} GB on {eng.kv.dev.device}), "
            f"tab stack {tuple(eng.tab.dev.shape)}")
        log(f"[serve] seed {seed}: ticks {batched.rounds}, waves {waves}, "
            f"receiver calls {tel['fused_receiver_calls']} "
            f"({tel['fused_receiver_lanes'] / max(1, tel['fused_receiver_calls']):.2f} lanes/call), "
            f"issuer calls {tel['fused_issuer_calls']} "
            f"({tel['fused_issuer_lanes'] / max(1, tel['fused_issuer_calls']):.2f} lanes/call), "
            f"host<->device {tel['transfer_bytes'] / max(1, waves):.0f} B/wave "
            f"({tel['transfer_bytes']} B total: staging up "
            f"{tel['stage_h2d_bytes']}, replies/actions down "
            f"{tel['gather_d2h_bytes']}, KV up {eng.kv.h2d_bytes} / down "
            f"{eng.kv.d2h_bytes}, tab up {eng.tab.h2d_bytes} / down "
            f"{eng.tab.d2h_bytes}; {tel['plane_syncs']} uploads), "
            f"batched wall {t_b:.2f} s, scalar wall {t_s:.2f} s")
    return runs, rec_r, rec_i, launches, waves_all


def phase_replay(torch, mods, rec_r, rec_i, apply_ok, propose_ok):
    for i, ins, outs in rec_r.samples:
        kv, msgreg = ins[0], ins[1]
        _, m, k = kv.shape
        want = mods.apply_ops.paxos_apply_plain(kv.view(18, m * k),
                                                msgreg.view(12, m * k))
        got = [outs[0].view(18, m * k), outs[1].view(11, m * k),
               outs[2].view(m * k)]
        apply_ok.add(torch, got, want, f"recorded receiver call {i}")
        log(f"[replay] receiver call {i} ({m}x{k} lanes): equal to plain")
    for i, ins, outs in rec_i.samples:
        tab, rep, params = ins
        _, m, s = tab.shape
        want = mods.propose_ops.paxos_propose_plain(
            tab.view(65, m * s), rep.view(13, m * s), params, s)
        got = [outs[0].view(65, m * s), outs[1].view(14, m * s)]
        propose_ok.add(torch, got, want, f"recorded issuer call {i}")
        log(f"[replay] issuer call {i} ({m}x{s} lanes): equal to plain")
    if not rec_r.samples or not rec_i.samples:
        raise AssertionError("no fused call was recorded")


def _is_device_row(row) -> bool:
    return str(getattr(row, "device_type", "")).endswith("CUDA")


def phase_idle(torch, mods, dev, n_ops, ticks=40):
    """Device busy share of the serve path: the device time the profiler
    sees over ``ticks`` ticks of seed 0, against the wall time of the same
    ticks run unprofiled on an identical cluster."""
    batched_cls = functools.partial(mods.BatchedMachine, device=dev)
    cl = _make_cluster(mods, batched_cls, 0, False, n_ops)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cl.step(ticks)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    twin = _make_cluster(mods, batched_cls, 0, False, n_ops)
    rows, prof_wall_ms = profile_device(torch, lambda: twin.step(ticks))
    dev_rows = [r for r in rows if _is_device_row(r) and _device_us(r) > 0]
    dev_ms = sum(_device_us(r) for r in dev_rows) / 1e3
    log(f"[idle] {ticks} ticks of seed 0: wall {wall_ms:.1f} ms unprofiled "
        f"({prof_wall_ms:.1f} ms profiled), device busy {dev_ms:.2f} ms -> "
        f"busy share {dev_ms / wall_ms:.4f}, idle share "
        f"{1 - dev_ms / wall_ms:.4f}")
    for r in sorted(dev_rows, key=_device_us, reverse=True)[:8]:
        log(f"[idle]   {_device_us(r) / 1e3:9.3f} ms  x{r.count:<5d} "
            f"{r.key[:90]}")
    return dict(wall_ms=wall_ms, device_ms=dev_ms)


def cuda_ms(torch, fn, reps, inner=1, warmup=3):
    """Median milliseconds per call over ``reps`` event-timed groups of
    ``inner`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _device_us(row) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(row, attr):
            return float(getattr(row, attr))
    return 0.0


def profile_device(torch, fn):
    """Run ``fn`` under torch.profiler; returns (key_averages rows, wall
    ms of the window).  Device times come from CUPTI."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return prof.key_averages(), wall_ms


def kernel_device_ms(torch, fn, calls, kernel_name):
    """Mean device time per launch of ``kernel_name`` over a profiled run
    of ``calls`` calls (None when the profiler saw no such kernel)."""
    fn()
    rows, _ = profile_device(torch, lambda: [fn() for _ in range(calls)])
    hits = [r for r in rows if kernel_name in r.key and _device_us(r) > 0]
    if not hits:
        return None
    return (sum(_device_us(r) for r in hits)
            / sum(r.count for r in hits) / 1e3)


def phase_timings(torch, mods, pv, dev, waves_all):
    out = {}
    n = M * KEYS
    kv, msgreg = apply_inputs(torch, n, 7, dev)
    bufs = (torch.empty_like(kv), torch.empty((11, n), dtype=torch.int32,
                                              device=dev),
            torch.empty((n,), dtype=torch.int32, device=dev))
    k_call = lambda: mods.apply_ops.paxos_apply(kv, msgreg, out=bufs)
    out["paxos_apply"] = dict(
        event_ms=cuda_ms(torch, k_call, 30),
        device_ms=kernel_device_ms(torch, k_call, 20, "paxos_apply_kernel"),
        plain_ms=cuda_ms(torch, lambda: mods.apply_ops.paxos_apply_plain(
            kv, msgreg), 5, warmup=1),
        bytes=(18 + 12 + 18 + 11 + 1) * 4 * n,
        ops=APPLY_OPS_PER_LANE * n, lanes=n)
    tab, rep, params = propose_inputs(torch, pv, M, SESSIONS, 8, dev)
    nn = M * SESSIONS
    pbufs = (torch.empty_like(tab), torch.empty((14, nn), dtype=torch.int32,
                                                device=dev))
    p_call = lambda: mods.propose_ops.paxos_propose(tab, rep, params,
                                                    SESSIONS, out=pbufs)
    out["paxos_propose"] = dict(
        event_ms=cuda_ms(torch, p_call, 20, inner=50),
        device_ms=kernel_device_ms(torch, p_call, 200,
                                   "paxos_propose_kernel"),
        plain_ms=cuda_ms(torch, lambda: mods.propose_ops.paxos_propose_plain(
            tab, rep, params, SESSIONS), 10, warmup=2),
        bytes=(65 + 13 + 65 + 14) * 4 * nn + 4 * 4 * M,
        ops=PROPOSE_OPS_PER_LANE * nn, lanes=nn)
    for name, t in out.items():
        # the kernel's own time is the profiler's device time; the event
        # time around back-to-back wrapper calls includes host launch cost
        t["ms"] = t["device_ms"] if t["device_ms"] is not None \
            else t["event_ms"]
        t["ms_source"] = ("profiler" if t["device_ms"] is not None
                          else "cuda events")
        t["bound_ms"] = max(t["bytes"] / HBM_BYTES_PER_S,
                            t["ops"] / INT32_OPS_PER_S) * 1e3
        t["bound_by"] = ("bytes" if t["bytes"] / HBM_BYTES_PER_S
                         >= t["ops"] / INT32_OPS_PER_S else "operations")
        log(f"[time] {name} at {t['lanes']} lanes: kernel {t['ms']:.6f} ms "
            f"({t['ms_source']}; {t['event_ms']:.6f} ms a wrapper call by "
            f"cuda events), bound {t['bound_ms']:.6f} ms ({t['bound_by']}, "
            f"{t['bytes']} B, {t['bytes'] / t['ms'] / 1e6:.1f} GB/s "
            f"achieved), plain {t['plain_ms']:.6f} ms")

    # what the reference's whole-stack transfers would cost a wave at this
    # width: KV pull + re-upload, message staging up, replies + mask down
    host_kv = torch.empty((18, M, KEYS), dtype=torch.int32, pin_memory=True)
    host_st = torch.empty((12, M, KEYS), dtype=torch.int32, pin_memory=True)
    dev_kv = torch.empty((18, M, KEYS), dtype=torch.int32, device=dev)
    dev_st = torch.empty((12, M, KEYS), dtype=torch.int32, device=dev)

    def whole_stack_wave():
        host_kv.copy_(dev_kv)
        dev_kv.copy_(host_kv)
        dev_st.copy_(host_st)
        host_st.copy_(dev_st)

    w_ms = cuda_ms(torch, whole_stack_wave, 5, warmup=1)
    w_bytes = (18 * 2 + 12 * 2) * 4 * M * KEYS
    log(f"[time] whole-stack transfers (not used by the port): "
        f"{w_bytes} B in {w_ms:.3f} ms per wave "
        f"({w_bytes / w_ms / 1e6:.1f} GB/s); x {waves_all} waves of the "
        f"serve phase = {w_ms * waves_all / 1e3:.1f} s")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-ops", type=int, default=N_OPS,
                    help="client ops per serve seed (default %(default)s)")
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch" / "kernels" / "_build.py").is_file():
        print("chip_smoke.py: src/repro_torch not found beside the script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this "
              "script measures the port on a CUDA card", file=sys.stderr)
        return 1

    from repro_torch.core import checkers
    from repro_torch.core import proposer_vector as pv
    from repro_torch.core.node import Machine, ProtocolConfig
    from repro_torch.core.sim import Cluster, NetConfig, completion_tuples, \
        workload
    from repro_torch.kernels import _build
    from repro_torch.kernels.paxos_apply import ops as apply_ops
    from repro_torch.kernels.paxos_propose import ops as propose_ops
    from repro_torch.serve.paxos import BatchedMachine, cluster_engine

    mods = argparse.Namespace(
        checkers=checkers, Machine=Machine, ProtocolConfig=ProtocolConfig,
        Cluster=Cluster, NetConfig=NetConfig,
        completion_tuples=completion_tuples, workload=workload,
        apply_ops=apply_ops, propose_ops=propose_ops,
        BatchedMachine=BatchedMachine, cluster_engine=cluster_engine)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()
    card = nvidia_smi_line()
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}; "
        f"nvidia-smi: {card}")

    phase_build(_build)
    apply_ok, propose_ok = phase_kernels(torch, apply_ops, propose_ops, pv,
                                         dev)
    if args.n_ops < N_OPS:
        log(f"[serve] n_ops cut from {N_OPS} to {args.n_ops}")
    runs, rec_r, rec_i, launches, waves_all = phase_serve(
        torch, mods, dev, args.n_ops)
    phase_replay(torch, mods, rec_r, rec_i, apply_ok, propose_ok)
    times = phase_timings(torch, mods, pv, dev, waves_all)
    phase_idle(torch, mods, dev, args.n_ops)
    torch.cuda.synchronize()
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")

    sources = {"paxos_apply": ("src/repro_torch/csrc/paxos_apply.cu",
                               "src/repro/kernels/paxos_apply/kernel.py:38",
                               "_paxos_apply_kernel", apply_ok),
               "paxos_propose": ("src/repro_torch/csrc/paxos_propose.cu",
                                 "src/repro/kernels/paxos_propose/kernel.py:45",
                                 "_paxos_propose_kernel", propose_ok)}
    kernels = []
    for name, (src, replaces, fn, agree) in sources.items():
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "replaces_function": fn,
            "launches": launches[name], "mismatches": agree.mismatches,
            "max_abs_err": agree.max_abs_err, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
