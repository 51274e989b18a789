#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout, on a machine with one CUDA card::

    python3 chip_smoke.py

Phases (any failure exits nonzero and prints no result):

1. **Build** the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc
   -c`` per source, all started together, then one link) and print the
   build time, ptxas' register/spill report per kernel and the card's
   name and power limit.
2. **Kernel vs plain** on random planes made from a seed on the card:
   ``paxos_apply`` at 5 x 2^20 lanes and at ragged lane counts,
   ``paxos_propose`` at 5 x 800 lanes and ragged counts, idle lanes and
   mixed per-machine quorum parameters; its staged entry
   ``paxos_propose_staged`` at 5 x 800 with 0, 1, 19, 127 and all 4000
   lanes staged, at 3 x 1667 and 12289 x 1 with ragged counts (the whole
   table compared after each in-place call, all lanes staged equal to the
   whole-stack kernel, a duplicate or out-of-range coordinate refused).
   Every output plane must equal the plain PyTorch version run on the card
   (0 mismatches).
3. **Full-width serve**: ``Cluster(machine_cls=BatchedMachine)`` on the
   card at 5 replicas x 800 sessions x 2^20 key lanes, the kv_mixed
   10/20/70 rmw/write/read mix over 2^20 keys, batched-smoke network
   faults; one plain seed and one all-aboard seed with a crash/restart of
   machine 4 mid-run.  Completions must equal the port's scalar cluster
   on the same seed, the safety checkers must be green, both kernels must
   have launched (``paxos_propose`` through its staged entry, once an
   issuer wave), and a sample of the fused calls is replayed through the
   plain versions on the card (a staged call against the whole-stack
   plain version).
4. **Timings** of each kernel at the main path's shapes (CUDA events,
   median after warm-up), its bound and its plain version's time; the
   staged entry at 19 and 4000 lanes; the whole-stack issuer wave (the
   whole-stack step, scatters, gather, pull) against the staged wave in
   turns on the card, and one profiled pass counting the staged wave's
   device operations; the card's busy share over 40 ticks of the serve
   path.
5. **Open-loop load** through the operations layer: ``OpenLoopHarness``
   on ``Cluster(machine_cls=BatchedMachine)`` at 5 replicas x 800 sessions
   x 2^20 Zipf(0.99) keys, the kv_mixed mix, 25 ops a tick for 200 ticks,
   2 % drops and duplicates, machine 4 crashed at tick 60 and restarted at
   85, a partition [0, 1, 2] | [3, 4] over ticks 120-150; seed 0 plain and
   seed 1 all-aboard, each with a sampled ``FlightRecorder``.  Completions,
   latency reports and path counts must equal the port's scalar cluster's,
   and the completions the reference's recorded run of the same spec
   (``tests/data/open_loop_reference.json``, by count and SHA-256); the
   path counters must reconcile with the history on both clusters; the
   checkers must say what they say of the reference's run (seed 0 green;
   seed 1 the reference protocol's linearizability fault, word for word);
   both kernels must have launched and a sample of the fused calls replays
   through the plain versions.  Prints each seed's bench lane, the
   recorder's ``engine.*`` counters, the host time inside the recorder's
   hooks, the batched wall time with the recorder in mode ``off`` and in
   mode ``sampled`` in turns, and the device's busy share over one run
   traced on the device, against that run's own wall.  A failure dumps the
   recorder under ``build/flight_dumps/`` and re-raises.
6. **Live reconfiguration**: the storm of ``scripts/reconfig_smoke.py``
   from 5 members (5 -> 6 -> 7 -> 6 -> 7 -> 6: a partition [2] | [0]
   across the two joins, machine 2 crashed across the first leave, the
   leaver rejoined) at 800 sessions over keys 1 .. 2^20 - 1, 4000 ops
   split 14 : 10 : 8, on the batched cluster on the card and on the scalar
   cluster.  Completions equal, checkers green (view transitions
   included), epoch 5 with 6 members, plane rows reloaded, both kernels
   launched, the first fused call at each machine count replayed through
   the plain versions, and a member's snapshot equal to its KV row on the
   card; the whole-row catch-up held to the per-key one on 4096 sampled
   lanes (reads, and two installs into fresh joiners on the card); prints
   the seconds and bytes of every snapshot taken and installed.
7. **Float kernels vs plain** on unit-normal inputs made on the card:
   ``flash_attention`` at zamba2's, gemma3's local, qwen1.5's ragged,
   Sq < Sk, non-causal and MQA shapes and a window straddling key tiles,
   ``mamba2_ssd`` at zamba2's layer, ragged T (T = 65 and 4097 are ragged
   by one step against its 64-step chunks), G = 2 and N = 128,
   ``rwkv6_wkv`` at rwkv6-7b's prefill and the smoke
   config's heads, ragged T (T = 65 and 4097 against its 64-step chunks),
   ragged V, K = 40 and B = 2 (decays exp(-exp(x)), x uniform on [-6, 1]),
   strong decays with exact zeros, and w = 1 over 4096 steps, each in
   float32 and bfloat16.
8. **Full-width zamba2-7b** (81 layers, d_model 3584, float32 weights from
   a seeded ``torch.Generator`` on the card): one prefill of 2 x 128
   tokens, the main path of its float kernels (their counts set to 0 just
   before it and read just after: 13 flash attention, 81 SSD), held
   against the teacher-forced ``decode_step`` loop over the same tokens
   (same top-1, max logit error <= 1e-3 of max |logit|); a sample of its
   kernel calls replayed through the plain versions; then ``DecodeEngine``
   routes 4 sessions through ``PaxosRegistry(n_machines=5)`` over
   ``BatchedMachine`` (sticky across two engines) and generates 32 steps.
9. **bf16 zamba2-7b prefill** at 1 x 4096 tokens (cut from the dry-run's
   ``prefill_32k``, batch 32): wall time, peak memory and one
   ``torch.profiler`` pass; a float kernel's time a call is its CUDA
   kernels' device time over its wrapper's calls in that pass.
10. **Full-width rwkv6-7b** (32 layers, d_model 4096, 7.5e9 float32
   weights, drawn after zamba2's are freed): phase 8 again, with 32
   ``rwkv6_wkv`` launches in the prefill.
11. **bf16 rwkv6-7b prefill** at 1 x 4096 tokens, as phase 9.
12. **Timings** of the three float kernels at their prefill shapes, their
    bounds, plain versions and, for attention, one
    ``scaled_dot_product_attention`` call (a yardstick the port never
    calls).

The last three lines of standard output are the ``nvidia-smi`` name and
power limit, one JSON object describing the five kernels, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import collections
import functools
import json
import pathlib
import re
import shutil
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
# table planes the issuer network reads (all 65 but ts_v, ts_m, has_value)
PROPOSE_TAB_READ = 62

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


def staged_inputs(torch, rep, m, s, n_staged, seed, dev):
    """``n_staged`` distinct lanes of an ``m x s`` stack in random order and
    the packed ``(2 + 13, n_staged)`` buffer staging ``rep``'s columns
    there: (flat lane indices, staged buffer, host coordinates)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    idx = torch.randperm(m * s, generator=g, device=dev)[:n_staged]
    staged = torch.cat([(idx // s)[None].to(torch.int32),
                        (idx % s)[None].to(torch.int32),
                        rep[:, idx]]).contiguous()
    return idx, staged, staged[:2].cpu().numpy()


# (m, s) of the stack, staged lane counts
STAGED_CASES = [((M, SESSIONS), (0, 1, 19, 127, M * SESSIONS)),
                ((3, 1667), (65, 777)), ((12289, 1), (4099,))]


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

def _demangle(names, tool_dir):
    """``{mangled: "kernel<template args>"}`` through the toolkit's
    ``cu++filt`` (or binutils' ``c++filt``); the mangled name where
    neither is found."""
    tools = [pathlib.Path(tool_dir) / "cu++filt", shutil.which("cu++filt"),
             shutil.which("c++filt")]
    tool = next((str(t) for t in tools if t and pathlib.Path(t).is_file()),
                None)
    if tool is None or not names:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, timeout=60).stdout.splitlines()
    if len(out) != len(names):
        return {n: n for n in names}
    return {n: _short_name(d) for n, d in zip(names, out)}


def _short_name(demangled: str) -> str:
    """``void <unnamed>::k<(int)7, (bool)0>(float const*, ...)`` ->
    ``k<7, 0>``: drop the return type, the namespace, the parameter list
    and the casts ``cu++filt`` puts on template arguments."""
    d = demangled.strip()
    if d.endswith(")"):                     # cut the trailing (params)
        depth = 0
        for i in range(len(d) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(d[i], 0)
            if depth == 0:
                d = d[:i]
                break
    d = re.sub(r"\((?:unsigned )?(?:int|bool|long)\)", "", d)
    for prefix in ("<unnamed>::", "(anonymous namespace)::"):
        d = d.replace(prefix, "")
    return d.removeprefix("void ").strip()


def phase_build(build):
    """Build the kernels; one line per kernel with ptxas' registers, static
    shared memory, stack and spills (the float kernels' tiles live in
    dynamic shared memory, whose size each .cu header states)."""
    lib = build.build()
    log(f"[build] nvcc {lib.build_seconds:.2f} s -> "
        f"{lib.path.relative_to(ROOT)}")
    usage, kernel = {}, None
    for line in lib.build_log.splitlines():
        if "Compiling entry function" in line and "'" in line:
            kernel = line.split("'")[1]
            usage[kernel] = []
        elif kernel and ("registers" in line or "spill" in line):
            usage[kernel].append(line.replace("ptxas info    :", "").strip())
    names = _demangle(list(usage), pathlib.Path(build.nvcc()).parent) \
        if usage else {}
    for mangled, parts in usage.items():
        log(f"[build] {names[mangled]}: {'; '.join(parts)}")
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
    for i, ((m, s), counts) in enumerate(STAGED_CASES):
        tab, rep, params = propose_inputs(torch, pv, m, s, 250 + i, dev)
        for j, n_staged in enumerate(counts):
            phase_staged_case(torch, propose_ops, tab, rep, params, m, s,
                              n_staged, 260 + 10 * i + j, propose_ok, dev)
    _staged_refusals(torch, propose_ops, pv, dev)
    return apply_ok, propose_ok


def phase_staged_case(torch, propose_ops, tab, rep, params, m, s, n_staged,
                      seed, propose_ok, dev):
    """The staged kernel against its plain version on clones of one table:
    the compact outputs and the whole table after the in-place call (the
    unstaged lanes untouched); with every lane staged, also against the
    whole-stack kernel."""
    idx, staged, coords = staged_inputs(torch, rep, m, s, n_staged, seed, dev)
    tab_k, tab_p = tab.clone(), tab.clone()
    got = propose_ops.paxos_propose_staged(tab_k, staged, params, s,
                                           coords=coords)
    want = propose_ops.paxos_propose_staged_plain(tab_p, staged, params, s)
    torch.cuda.synchronize()
    what = f"paxos_propose_staged {m}x{s} L={n_staged}"
    pairs = [(tab_k, tab_p)] + ([(got, want)] if n_staged else [])
    propose_ok.add(torch, *zip(*pairs), what)
    note = ""
    if n_staged == m * s:
        whole_tab, whole_act = propose_ops.paxos_propose(
            tab, propose_ops.dense_replies(staged, m, s), params, s)
        rows = torch.from_numpy(propose_ops.CHANGED_ROWS).to(dev)
        torch.cuda.synchronize()
        propose_ok.add(torch, [tab_k, got[:14], got[14:]],
                       [whole_tab, whole_act[:, idx],
                        whole_tab[rows][:, idx]],
                       f"{what} vs the whole-stack kernel")
        note = "; equal to the whole-stack kernel"
    changed = int((tab_k != tab).any(0).sum())
    log(f"[kernels] {what}: 0 mismatches over {got.numel()} outputs and "
        f"the whole {tuple(tab.shape)} table ({changed} lanes changed, "
        f"{torch.unique(got[0]).numel() if n_staged else 0} distinct "
        f"decisions){note}")


def _staged_refusals(torch, propose_ops, pv, dev):
    """A duplicate or out-of-range staged coordinate raises before any
    launch."""
    import numpy as np

    tab, rep, params = propose_inputs(torch, pv, 2, 4, 290, dev)
    for what, coords in (("duplicate", [[1, 0, 1], [3, 2, 3]]),
                         ("row out of range", [[0, 2], [0, 1]]),
                         ("lane out of range", [[0, 1], [4, 1]])):
        c = np.array(coords, np.int32)
        staged = torch.cat([torch.from_numpy(c).to(dev),
                            rep[:, :c.shape[1]]]).contiguous()
        before = propose_ops.paxos_propose.launches
        try:
            propose_ops.paxos_propose_staged(tab, staged, params, 4, coords=c)
        except ValueError as exc:
            if propose_ops.paxos_propose.launches != before:
                raise AssertionError(f"staged {what}: launched before "
                                     f"refusing")
            log(f"[kernels] paxos_propose_staged {what}: refused ({exc})")
            continue
        raise AssertionError(f"paxos_propose_staged accepted a {what}")


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


def _snapshot(v):
    """A copy of a tensor or array argument; other values as they are."""
    if hasattr(v, "clone"):
        return v.clone()
    return v.copy() if hasattr(v, "copy") else v


class Recorder:
    """Clones the inputs and outputs of a few fused calls on the card;
    ``after`` names positional arguments updated in place, which are
    cloned again after the call and kept after the outputs."""

    def __init__(self, torch, fn, keep, after=()):
        self.torch, self.fn, self.keep = torch, fn, set(keep)
        self.after = tuple(after)
        self.calls = 0
        self.samples = []

    def __call__(self, *args, **kw):
        i = self.calls
        self.calls += 1
        if i not in self.keep:
            return self.fn(*args, **kw)
        ins = [_snapshot(a) for a in args]
        kw_in = {k: _snapshot(v) for k, v in kw.items()}
        outs = self.fn(*args, **kw)
        kept = outs if isinstance(outs, (tuple, list)) else [outs]
        self.samples.append((i, ins, kw_in,
                             [o.clone() for o in kept]
                             + [args[j].clone() for j in self.after]))
        return outs


def phase_serve(torch, mods, dev, n_ops):
    ce = mods.cluster_engine
    rec_r = Recorder(torch, ce._fused_receiver_step, (0, 7, 70, 400))
    # the staged issuer step updates the table (argument 0) in place
    rec_i = Recorder(torch, ce.paxos_propose_staged, (0, 7, 70, 400),
                     after=(0,))
    batched_cls = functools.partial(mods.BatchedMachine, device=dev)
    runs = []
    # the main path: counts start at 0 here and are read right after
    mods.apply_ops.paxos_apply.launches = 0
    mods.propose_ops.paxos_propose.launches = 0
    ce._fused_receiver_step, ce.paxos_propose_staged = rec_r, rec_i
    try:
        for seed, aboard, crash in ((0, False, False), (1, True, True)):
            torch.cuda.synchronize()
            batched, t_b = _serve_cluster(mods, batched_cls, seed, aboard,
                                          crash, n_ops)
            torch.cuda.synchronize()
            runs.append((seed, aboard, crash, batched, t_b))
    finally:
        ce._fused_receiver_step = rec_r.fn
        ce.paxos_propose_staged = rec_i.fn
    launches = {"paxos_apply": mods.apply_ops.paxos_apply.launches,
                "paxos_propose": mods.propose_ops.paxos_propose.launches}
    log(f"[serve] main-path launches: {json.dumps(launches)}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    # every paxos_propose launch came from the staged entry, one a wave
    issuer_calls = sum(r[3].engine.stats["fused_issuer_calls"] for r in runs)
    if not launches["paxos_propose"] == rec_i.calls == issuer_calls:
        raise AssertionError(
            f"paxos_propose launched {launches['paxos_propose']} times, the "
            f"staged entry was called {rec_i.calls} times, for "
            f"{issuer_calls} issuer waves")
    log(f"[serve] paxos_propose: all {issuer_calls} launches through the "
        f"staged entry, one an issuer wave")

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
        iss_waves = tel["fused_issuer_calls"]
        log(f"[serve] seed {seed}: issuer waves {iss_waves}, host waits "
            f"{tel['issuer_wave_syncs']} "
            f"({tel['issuer_wave_syncs'] / max(1, iss_waves):.2f} a wave), "
            f"tab pull bytes {eng.tab.d2h_bytes}")
    return runs, rec_r, rec_i, launches, waves_all


def phase_replay(torch, mods, rec_r, rec_i, apply_ok, propose_ok):
    for i, ins, _, outs in rec_r.samples:
        kv, msgreg = ins[0], ins[1]
        _, m, k = kv.shape
        want = mods.apply_ops.paxos_apply_plain(kv.view(18, m * k),
                                                msgreg.view(12, m * k))
        got = [outs[0].view(18, m * k), outs[1].view(11, m * k),
               outs[2].view(m * k)]
        apply_ok.add(torch, got, want, f"recorded receiver call {i}")
        log(f"[replay] receiver call {i} ({m}x{k} lanes): equal to plain")
    ops = mods.propose_ops
    for i, ins, _, outs in rec_i.samples:
        # the staged call against the whole-stack plain version: its
        # replies scattered into an idle stack, the whole table compared
        tab, staged, params, s = ins
        out, tab_after = outs
        m = params.shape[1]
        want_tab, want_act = ops.paxos_propose_plain(
            tab, ops.dense_replies(staged, m, s), params, s)
        idx = staged[0].long() * s + staged[1].long()
        rows = torch.from_numpy(ops.CHANGED_ROWS).to(tab.device)
        propose_ok.add(torch, [tab_after, out[:14], out[14:]],
                       [want_tab, want_act[:, idx], want_tab[rows][:, idx]],
                       f"recorded issuer call {i}")
        log(f"[replay] issuer call {i} ({staged.shape[1]} staged lanes of "
            f"{m}x{s}): table and actions equal to the whole-stack plain "
            f"version")
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


# ---------------------------------------------------------------------------
# the operations layer: open-loop load, the flight recorder, live
# reconfiguration with snapshot catch-up
# ---------------------------------------------------------------------------

KIND_TO_PATHS = {"RMW": ("all_aboard_fast", "cp_slow"),
                 "READ": ("abd_read",), "WRITE": ("abd_write",)}
# where a failing run's flight recorder is dumped (gitignored)
DUMP_DIR = ROOT / "build" / "flight_dumps"
# the open-loop cell: Poisson arrivals at 25 ops a tick for 200 ticks
OL_RATE, OL_TICKS = 25.0, 200.0
# the storm's 4000 ops, split 14 : 10 : 8 as scripts/reconfig_smoke.py
# splits its three loads
STORM_OPS = (1750, 1250, 1000)


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reconcile_paths(rec, cluster, what):
    """The recorder's per-path counters against the completion history,
    exactly (as scripts/open_loop_smoke.py reconciles them)."""
    kinds = collections.Counter(h["kind"].name for h in cluster.history)
    paths = rec.path_counts()
    for kind, names in KIND_TO_PATHS.items():
        got = sum(paths[p] for p in names)
        if got != kinds.get(kind, 0):
            raise AssertionError(
                f"{what}: {kind} path counters ({got}) do not reconcile "
                f"with {kinds.get(kind, 0)} completions")
    if sum(paths.values()) != len(cluster.history):
        raise AssertionError(
            f"{what}: {sum(paths.values())} path counts for "
            f"{len(cluster.history)} completions")


def _first_diff(got, want):
    if len(got) != len(want):
        return f"{len(got)} vs {len(want)} completions"
    return next(f"{a} vs {b}" for a, b in zip(got, want) if a != b)


def open_loop_spec(mods, seed, sessions=SESSIONS, n_keys=KEYS,
                   rate=OL_RATE, ticks=OL_TICKS):
    lg = mods.loadgen
    return lg.OpenLoopSpec(
        seed=seed, n_machines=M, sessions=sessions, n_keys=n_keys,
        zipf_s=0.99, mix=lg.MIXES["kv_mixed"],
        phases=(lg.ArrivalPhase(rate=rate, ticks=ticks),),
        all_aboard=seed == 1, drop_prob=0.02, dup_prob=0.02)


def open_loop_faults(mods):
    return (mods.loadgen.FaultPlan(settle=30.0)
            .crash_restart(4, at=60.0, down_for=25.0)
            .partition(120.0, 150.0, (0, 1, 2), (3, 4)))


class HookClock:
    """Host seconds spent inside a ``FlightRecorder``'s hooks and its
    registry's updates (the machines, engine schedulers and harness call
    them); a hook that calls another counts once.  The schedulers' gauge
    reads before a publish are outside the clock."""

    HOOKS = ("op_begin", "op_event", "rmw_aboard", "rmw_classic",
             "rmw_retry", "rmw_steal", "rmw_help", "quorum_wait", "rmw_end",
             "abd_end", "machine_crash", "note")
    REGISTRY = ("inc", "set_gauge", "observe")

    def __init__(self):
        self.seconds = 0.0
        self.calls = 0
        self._inside = False

    def wrap(self, rec):
        for obj, names in ((rec, self.HOOKS), (rec.registry, self.REGISTRY)):
            for name in names:
                setattr(obj, name, self._timed(getattr(obj, name)))
        return rec

    def _timed(self, fn):
        def timed(*args, **kw):
            if self._inside:
                return fn(*args, **kw)
            self._inside = True
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.seconds += time.perf_counter() - t0
                self.calls += 1
                self._inside = False
        return timed


def run_open_loop(torch, mods, dev, spec, machine_cls, mode, clock=None):
    """One open-loop run with a ``FlightRecorder`` in ``mode`` (None: no
    recorder), its hooks timed by ``clock`` if given; returns (result,
    recorder, wall seconds).  The checkers run apart from the timed run
    (``check_open_loop``)."""
    rec = None if mode is None else mods.FlightRecorder(
        mode=mode, meta={"seed": spec.seed, "spec": "chip_smoke open_loop"})
    if clock is not None:
        clock.wrap(rec)
    harness = mods.loadgen.OpenLoopHarness(
        spec, machine_cls=machine_cls, faults=open_loop_faults(mods), obs=rec)
    _sync(torch, dev)
    t0 = time.perf_counter()
    res = harness.run(check=False)
    _sync(torch, dev)
    return res, rec, time.perf_counter() - t0


# The reference's scalar cluster on the [open_loop] specs, recorded by
# tests/test_torch_open_loop.py (which holds the reference to it on every
# test run): seed -> the spec, the faults, the count and SHA-256 of its
# completion tuples and the checkers' verdict.  Seed 1 meets a fault of the
# reference's protocol (ROADMAP, Queue 3): an all-aboard RMW issued by
# machine 4 at its restart (tick 85) commits at a base older than a write
# that completed at tick 66, and the checkers raise it.
REFERENCE_RECORD = ROOT / "tests" / "data" / "open_loop_reference.json"


def reference_record(spec, faults):
    """The reference's recorded run of ``spec`` under ``faults``."""
    record = json.loads(REFERENCE_RECORD.read_text())[str(spec.seed)]
    if (record["spec"] != repr(spec)
            or record["faults"] != repr((faults.settle, faults.events))):
        raise AssertionError(f"{REFERENCE_RECORD.name} records another run "
                             f"for seed {spec.seed}: {record['spec']}")
    return record


def check_open_loop(mods, res, rec, record, what):
    """The harness's ``check=True``: every safety checker on the final
    cluster, a failure noted in the recorder's ring; then the path counters
    against the history.  The run must complete what the reference's run
    completed, tag for tag (by digest), and the checkers must say what they
    said of it: green, or the same violation word for word."""
    got = mods.completion_tuples(res.cluster)
    digest = mods.completion_digest(got)
    if (len(got), digest) != (record["completions"], record["digest"]):
        raise AssertionError(
            f"{what}: {len(got)} completions, digest {digest}; the "
            f"reference's run has {record['completions']}, digest "
            f"{record['digest']}")
    verdict = "green"
    try:
        mods.checkers.check_all(res.cluster)
    except mods.checkers.SafetyViolation as exc:
        rec.note("checker_failure", res.cluster.network.now, error=str(exc))
        if str(exc) != record["checkers"]:
            raise
        verdict = str(exc)
        log(f"[open_loop] {what}: the checkers raise the violation they "
            f"raise on the reference's run of this spec, whose completions "
            f"this run equals (ROADMAP, Queue 3): {exc}")
    if verdict != record["checkers"]:
        raise AssertionError(f"{what}: checkers green, the reference's run "
                             f"raises {record['checkers']!r}")
    reconcile_paths(rec, res.cluster, what)
    return verdict


def phase_open_loop(torch, mods, dev, apply_ok, propose_ok,
                    sessions=SESSIONS, n_keys=KEYS, rate=OL_RATE,
                    ticks=OL_TICKS, profile=True):
    ce = mods.cluster_engine
    batched_cls = functools.partial(mods.BatchedMachine, device=dev)
    rec_r = Recorder(torch, ce._fused_receiver_step, (0, 7, 70, 400))
    rec_i = Recorder(torch, ce.paxos_propose_staged, (0, 7, 70, 400),
                     after=(0,))
    specs = [open_loop_spec(mods, seed, sessions, n_keys, rate, ticks)
             for seed in (0, 1)]
    runs, clocks = [], []
    # the main path: counts start at 0 here and are read right after
    mods.apply_ops.paxos_apply.launches = 0
    mods.propose_ops.paxos_propose.launches = 0
    ce._fused_receiver_step, ce.paxos_propose_staged = rec_r, rec_i
    try:
        for spec in specs:
            clocks.append(HookClock())
            runs.append((spec,) + run_open_loop(
                torch, mods, dev, spec, batched_cls, "sampled", clocks[-1]))
    finally:
        ce._fused_receiver_step = rec_r.fn
        ce.paxos_propose_staged = rec_i.fn
    launches = {"paxos_apply": mods.apply_ops.paxos_apply.launches,
                "paxos_propose": mods.propose_ops.paxos_propose.launches}
    log(f"[open_loop] main-path launches: {json.dumps(launches)}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} never launched in [open_loop]")
    issuer_calls = sum(r[1].cluster.engine.stats["fused_issuer_calls"]
                       for r in runs)
    if not launches["paxos_propose"] == rec_i.calls == issuer_calls:
        raise AssertionError(
            f"[open_loop] paxos_propose launched {launches['paxos_propose']}"
            f" times, the staged entry was called {rec_i.calls} times, for "
            f"{issuer_calls} issuer waves")
    out = {"launches": launches, "wall_s": {}, "hook_s": {}}
    for (spec, res, rec, wall), clock in zip(runs, clocks):
        what = f"open_loop seed {spec.seed}"
        with mods.flight_guard(rec, str(DUMP_DIR), label=what,
                               stem=f"open_loop_seed{spec.seed}"):
            record = reference_record(spec, open_loop_faults(mods))
            verdict = check_open_loop(mods, res, rec, record, what)
            scalar, s_rec, s_wall = run_open_loop(torch, mods, dev, spec,
                                                  mods.Machine, "sampled")
            check_open_loop(mods, scalar, s_rec, record, what + " scalar")
            got = mods.completion_tuples(res.cluster)
            want = mods.completion_tuples(scalar.cluster)
            if got != want:
                raise AssertionError(f"{what}: batched completions differ "
                                     f"from scalar: {_first_diff(got, want)}")
            if rec.path_counts() != s_rec.path_counts():
                raise AssertionError(f"{what}: path counts differ from "
                                     f"scalar")
            if res.recorder.report() != scalar.recorder.report():
                raise AssertionError(f"{what}: latency report differs from "
                                     f"scalar")
            eng = res.cluster.engine
            if eng.kv.n_lanes != n_keys or eng.kv.dev.device != dev:
                raise AssertionError(
                    f"{what}: KV stack {tuple(eng.kv.dev.shape)} on "
                    f"{eng.kv.dev.device}, want {n_keys} lanes on {dev}")
        lane = res.lane()
        out["wall_s"][spec.seed] = wall
        out["hook_s"][spec.seed] = clock.seconds
        log(f"[open_loop] seed {spec.seed} "
            f"({'all-aboard' if spec.all_aboard else 'plain'}, crash/restart"
            f" m4 at 60, partition [0,1,2]|[3,4] at 120-150): "
            f"{len(got)} completions identical to scalar and to the "
            f"reference's recorded run, checkers "
            f"{'green' if verdict == 'green' else 'as on the reference'}, "
            f"path counters reconcile on both ({json.dumps(rec.path_counts())}"
            f"); KV stack {tuple(eng.kv.dev.shape)}; batched wall "
            f"{wall:.3f} s, scalar wall {s_wall:.3f} s")
        log(f"[open_loop] seed {spec.seed} lane: offered {lane['offered']}, "
            f"completed {lane['completed']}, lost {lane['lost']}, ticks "
            f"{lane['ticks']}, offered {lane['offered_ops_per_tick']} ops a "
            f"tick, achieved {lane['achieved_ops_per_tick']} ops a tick, by "
            f"class {json.dumps(lane['offered_by_class'])}")
        for window, cells in lane["windows"].items():
            log(f"[open_loop] seed {spec.seed} {window}: "
                + json.dumps(cells, sort_keys=True))
        snap = rec.snapshot()
        c, g = snap["counters"], snap["gauges"]
        engine = {k[len("engine."):]: v for k, v in c.items()
                  if k.startswith("engine.")}
        log(f"[open_loop] seed {spec.seed} engine.* counters: "
            + json.dumps(engine, sort_keys=True))
        log(f"[open_loop] seed {spec.seed}: waves {c['engine.waves']}, "
            f"receiver lanes a call "
            f"{g['engine.receiver_lanes_per_call']:.3f}, issuer lanes a call "
            f"{g['engine.issuer_lanes_per_call']:.3f}, transfer bytes a wave "
            f"{c['engine.transfer_bytes'] / max(1, c['engine.waves']):.1f}, "
            f"ring records {len(rec.ring)}")
        log(f"[open_loop] seed {spec.seed} recorder hooks: {clock.calls} "
            f"calls, {clock.seconds:.4f} s of host time, "
            f"{clock.seconds / wall:.4f} of the run's {wall:.3f} s wall, "
            f"{clock.seconds / max(1, c['engine.waves']) * 1e6:.2f} us a "
            f"wave")
    phase_replay(torch, mods, rec_r, rec_i, apply_ok, propose_ok)
    # what the ring costs: seed 0 with the recorder in mode off (exact
    # counters, no ring) and in mode sampled, in turns
    turns = {"off": [], "sampled": []}
    for mode in ("off", "sampled", "sampled", "off"):
        _, _, w = run_open_loop(torch, mods, dev, specs[0], batched_cls, mode)
        turns[mode].append(w)
    med = {m: statistics.median(ws) for m, ws in turns.items()}
    log(f"[open_loop] recorder cost, seed 0 batched wall in turns (off, "
        f"sampled, sampled, off): "
        + ", ".join(f"{m} {' / '.join(f'{w:.3f}' for w in ws)} s"
                    for m, ws in turns.items())
        + f"; sampled over off {med['sampled'] / med['off'] - 1:+.4f}")
    out["turns"] = turns
    if profile:
        t0 = time.perf_counter()
        rows, prof_ms = profile_device(torch, lambda: run_open_loop(
            torch, mods, dev, specs[0], batched_cls, "sampled"), cpu=False)
        dev_rows = [r for r in rows if _is_device_row(r)
                    and _device_us(r) > 0]
        dev_ms = sum(_device_us(r) for r in dev_rows) / 1e3
        others = [dev_ms / (w * 1e3) for w in turns["sampled"]]
        log(f"[open_loop] seed 0 device busy {dev_ms:.2f} ms over the same "
            f"run's {prof_ms:.1f} ms of wall (the device alone traced; "
            f"{time.perf_counter() - t0:.1f} s with the trace's processing):"
            f" busy share {dev_ms / prof_ms:.4f}, idle share "
            f"{1 - dev_ms / prof_ms:.4f}; the same device time over the "
            f"unprofiled sampled turns' walls gives busy shares "
            f"{min(others):.4f}-{max(others):.4f}")
        for r in sorted(dev_rows, key=_device_us, reverse=True)[:6]:
            log(f"[open_loop]   {_device_us(r) / 1e3:9.3f} ms  "
                f"x{r.count:<5d} {r.key[:90]}")
        out["busy_ms"], out["busy_wall_ms"] = dev_ms, prof_ms
    return out


class GrowthRecorder(Recorder):
    """A Recorder that also keeps the first call at each machine-axis size
    (``axis(args)``): the first waves after a joiner's rows were added."""

    def __init__(self, torch, fn, keep, axis, after=()):
        super().__init__(torch, fn, keep, after)
        self.axis = axis
        self.seen = set()

    def __call__(self, *args, **kw):
        m = self.axis(args)
        if m not in self.seen:
            self.seen.add(m)
            self.keep.add(self.calls)
        return super().__call__(*args, **kw)


def storm(mods, machine_cls, seed=0, sessions=SESSIONS, n_keys=KEYS,
          ops=STORM_OPS):
    """scripts/reconfig_smoke.py's storm from 5 members: 5 -> 6 -> 7 -> 6
    -> 7 -> 6, a partition [2]|[0] across the two joins, machine 2 crashed
    across the first leave, the leaver rejoined, the second joiner retired;
    the load on keys 1 .. n_keys - 1 (key 0 is the config register)."""
    cfg = mods.ProtocolConfig(n_machines=M, sessions_per_machine=sessions,
                              reconfig=True)
    net = mods.NetConfig(seed=seed, drop_prob=0.06, dup_prob=0.05,
                         heavy_tail_prob=0.03, heavy_tail_extra=25.0)
    cl = mods.Cluster(cfg, net, machine_cls=machine_cls)
    keys = n_keys - 1
    mods.workload(cl, n_ops=ops[0], keys=keys, seed=seed, rmw_frac=0.5,
                  write_frac=0.3, key_base=1)
    cl.step(150)
    cl.network.partition([2], [0])
    cl.join()                                    # epoch 1: 6 members
    second = cl.join()                           # epoch 2: 7 members
    cl.network.heal()
    mods.workload(cl, n_ops=ops[1], keys=keys, seed=seed + 1, rmw_frac=0.5,
                  write_frac=0.2, key_base=1, mids=cl.active_view.members)
    cl.crash(2)
    cl.leave(1)                                  # epoch 3: 6 members
    cl.restart(2)
    if cl.join(1) != 1:                          # epoch 4: 7 members
        raise AssertionError("the leaver did not rejoin under its own id")
    mods.workload(cl, n_ops=ops[2], keys=keys, seed=seed + 2, rmw_frac=0.6,
                  write_frac=0.2, key_base=1, mids=cl.active_view.members)
    cl.leave(second)                             # epoch 5: 6 members
    if not cl.run_until_quiet(max_ticks=120_000):
        raise RuntimeError(f"storm seed {seed}: cluster did not quiesce")
    st = cl.stats()
    if st["view_epoch"] != 5 or st["view_members"] != 6:
        raise AssertionError(
            f"storm seed {seed} ended at epoch {st['view_epoch']} with "
            f"{st['view_members']} members (want epoch 5, 6 members)")
    return cl


class CatchupClock:
    """Times every ``take_snapshot`` / ``install_snapshot`` the machines
    make (they import both from ``reconfig.catchup`` at call time)."""

    def __init__(self, catchup):
        self.catchup = catchup
        self.events = []
        self._fns = (catchup.take_snapshot, catchup.install_snapshot)

    def __enter__(self):
        take, install = self._fns

        def timed_take(machine):
            t0 = time.perf_counter()
            snap = take(machine)
            self.events.append(("take", machine.mid,
                                time.perf_counter() - t0,
                                sum(v.nbytes for v in snap.values()),
                                len(snap["keys"])))
            return snap

        def timed_install(machine, snap):
            t0 = time.perf_counter()
            install(machine, snap)
            self.events.append(("install", machine.mid,
                                time.perf_counter() - t0,
                                sum(v.nbytes for v in snap.values()),
                                len(snap["keys"])))

        self.catchup.take_snapshot = timed_take
        self.catchup.install_snapshot = timed_install
        return self

    def __exit__(self, *exc):
        self.catchup.take_snapshot, self.catchup.install_snapshot = self._fns


def phase_reconfig(torch, mods, dev, apply_ok, propose_ok,
                   sessions=SESSIONS, n_keys=KEYS, ops=STORM_OPS):
    ce = mods.cluster_engine
    batched_cls = functools.partial(mods.BatchedMachine, device=dev)
    rec_r = GrowthRecorder(torch, ce._fused_receiver_step, (0,),
                           lambda a: a[0].shape[1])
    rec_i = GrowthRecorder(torch, ce.paxos_propose_staged, (0,),
                           lambda a: a[2].shape[1], after=(0,))
    mods.apply_ops.paxos_apply.launches = 0
    mods.propose_ops.paxos_propose.launches = 0
    ce._fused_receiver_step, ce.paxos_propose_staged = rec_r, rec_i
    try:
        with CatchupClock(mods.catchup) as clock:
            _sync(torch, dev)
            t0 = time.perf_counter()
            batched = storm(mods, batched_cls, sessions=sessions,
                            n_keys=n_keys, ops=ops)
            _sync(torch, dev)
            t_b = time.perf_counter() - t0
    finally:
        ce._fused_receiver_step = rec_r.fn
        ce.paxos_propose_staged = rec_i.fn
    launches = {"paxos_apply": mods.apply_ops.paxos_apply.launches,
                "paxos_propose": mods.propose_ops.paxos_propose.launches}
    log(f"[reconfig] main-path launches: {json.dumps(launches)}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} never launched in [reconfig]")
    issuer_calls = batched.engine.stats["fused_issuer_calls"]
    if not launches["paxos_propose"] == rec_i.calls == issuer_calls:
        raise AssertionError(
            f"[reconfig] paxos_propose launched {launches['paxos_propose']} "
            f"times, the staged entry {rec_i.calls} times, for "
            f"{issuer_calls} issuer waves")
    t0 = time.perf_counter()
    scalar = storm(mods, mods.Machine, sessions=sessions, n_keys=n_keys,
                   ops=ops)
    t_s = time.perf_counter() - t0
    got = mods.completion_tuples(batched)
    want = mods.completion_tuples(scalar)
    if got != want:
        raise AssertionError(f"[reconfig] batched completions differ from "
                             f"scalar: {_first_diff(got, want)}")
    mods.checkers.check_all(scalar)
    mods.checkers.check_all(batched)
    tel = batched.engine.telemetry()
    if tel["row_reloads"] <= 0:
        raise AssertionError("[reconfig] no plane row was reloaded")
    eng = batched.engine
    if eng.kv.n_lanes != n_keys or eng.kv.dev.device != dev:
        raise AssertionError(f"[reconfig] KV stack {tuple(eng.kv.dev.shape)}"
                             f" on {eng.kv.dev.device}")
    st = batched.stats()
    log(f"[reconfig] storm 5 -> 6 -> 7 -> 6 -> 7 -> 6 over {sum(ops)} ops "
        f"({'/'.join(map(str, ops))}): {len(got)} completions identical to "
        f"scalar, checkers green (view transitions included), epoch "
        f"{st['view_epoch']}, {st['view_members']} members "
        f"{batched.active_view.members}, {st['sync_installed']} snapshots "
        f"installed, {st['net_removed_dst']} fenced sends; KV stack "
        f"{tuple(eng.kv.dev.shape)} ({eng.kv.dev.numel() * 4 / 1e9:.3f} GB "
        f"on {eng.kv.dev.device}); row reloads {tel['row_reloads']}, waves "
        f"{tel['waves']}, transfer bytes {tel['transfer_bytes']}; batched "
        f"wall {t_b:.3f} s, scalar wall {t_s:.3f} s")
    for kind, mid, secs, nbytes, nkeys in clock.events:
        verb = "served by" if kind == "take" else "installed on"
        log(f"[reconfig] {kind}_snapshot {verb} m{mid}: {secs:.4f} s, "
            f"{nbytes} B, {nkeys} keys")
    phase_replay(torch, mods, rec_r, rec_i, apply_ok, propose_ok)
    # the snapshot sees every landed wave: a member's snapshot is its row
    # on the card, plane for plane
    donor = batched.machines[0]
    donor.kvs.flush()
    eng.kv.push()
    _sync(torch, dev)
    snap = mods.catchup.take_snapshot(donor)
    row = eng.kv.dev[:, donor.mid].cpu().numpy()
    for i, f in enumerate(eng.kv.fields):
        if not mods.np.array_equal(snap[f"kv_{f}"], row[i]):
            raise AssertionError(f"[reconfig] snapshot plane {f} differs "
                                 f"from m{donor.mid}'s row on the card")
    log(f"[reconfig] m{donor.mid}'s snapshot equals its KV row on the card "
        f"({row.shape[1]} lanes x {row.shape[0]} planes)")
    catchup_sampled_keys(torch, mods, dev, batched, donor, snap)
    return {"wall_s": t_b, "scalar_s": t_s, "events": clock.events,
            "launches": launches}


def catchup_sampled_keys(torch, mods, dev, cl, donor, snap, n_sample=4096):
    """Holds the whole-row catch-up to the per-key one (a checkout and a
    merge a key) at full width, on ``n_sample`` lanes: up to half of them
    lanes where ``donor``'s snapshot ``snap`` and another member's differ,
    the rest drawn at random.  The per-key read of each sampled key must
    give the whole-row snapshot's entries, and a joiner that installs the
    two snapshots row by row must hold, on the card, what a joiner that
    installs them key by key holds."""
    np, cu = mods.np, mods.catchup
    other = next(m for m in cl.machines if m.mid != donor.mid
                 and m.mid in cl.active_view.members)
    snap2 = cu.take_snapshot(other)
    fields = cu._KV_FIELDS
    differs = np.zeros(len(snap["keys"]), bool)
    for f in fields:
        differs |= snap[f"kv_{f}"] != snap2[f"kv_{f}"]
    rng = np.random.default_rng(0)
    keys = np.flatnonzero(differs)[:n_sample // 2]
    rest = np.setdiff1d(np.arange(len(snap["keys"])), keys)
    keys = np.sort(np.concatenate([keys, rng.choice(
        rest, n_sample - len(keys), replace=False)]))
    for key in keys.tolist():
        lanes = mods.kv_to_lanes(donor.kvs[key])
        if any(lanes[f] != snap[f"kv_{f}"][key] for f in fields):
            raise AssertionError(f"[reconfig] m{donor.mid}'s key {key} read "
                                 f"per key differs from its snapshot")
    donor.kvs.drop_views()
    rows = []
    for install, pick in ((cu._install_kv, lambda sn: sn),
                          (cu._install_kv_per_key, lambda sn: {
                              "keys": sn["keys"][keys],
                              **{f"kv_{f}": sn[f"kv_{f}"][keys]
                                 for f in fields}})):
        m = mods.BatchedMachine(0, cl.cfg, lambda *a: None, lambda: 0.0,
                                device=dev)
        m.kvs.ensure(len(snap["keys"]) - 1)
        t0 = time.perf_counter()
        for sn in (snap2, snap):
            install(m, pick(sn))
        m.kvs.flush()
        m.kvs._stack.push()
        _sync(torch, dev)
        lanes = torch.as_tensor(keys, device=dev)
        rows.append((m.kvs._stack.dev[:, m._mi, lanes],
                     time.perf_counter() - t0))
    (row, t_row), (per_key, t_key) = rows
    if not torch.equal(row, per_key):
        raise AssertionError("[reconfig] whole-row and per-key installs "
                             "differ on the card")
    log(f"[reconfig] catch-up held to the per-key path on {len(keys)} lanes "
        f"({int(differs.sum())} lanes differ between m{donor.mid}'s and "
        f"m{other.mid}'s snapshots): per-key reads equal the snapshot, and "
        f"two installs give the same lanes on the card (whole rows "
        f"{t_row:.3f} s, {len(keys)} keys one by one {t_key:.3f} s)")


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


def profile_device(torch, fn, cpu=True):
    """Run ``fn`` under torch.profiler; returns (key_averages rows, wall
    ms of the window).  Device times come from CUPTI; ``cpu=False`` traces
    the device alone (a long host-bound window records millions of host
    operations otherwise)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
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

    phase_staged_timings(torch, mods, tab, rep, params, dev)

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


def phase_staged_timings(torch, mods, tab, rep, params, dev):
    """The staged entry's device and wrapper time at 19 lanes (a serve
    wave's) and at all 4000 lanes of the 5 x 800 stack, staged in random
    order (each lane's table column is then its own gather) and in lane
    order, against its bytes bound: 8 B of coordinates and 52 B of
    replies, the 62 table planes the network reads, the 44 changed planes
    written back and the 58 output planes, a lane, plus the parameter
    columns of the rows staged."""
    ops = mods.propose_ops
    for n_staged, order in ((19, "random"), (M * SESSIONS, "random"),
                            (M * SESSIONS, "lane")):
        idx, staged, coords = staged_inputs(torch, rep, M, SESSIONS,
                                            n_staged, 9, dev)
        if order == "lane":
            staged = staged[:, idx.argsort()].contiguous()
            coords = staged[:2].cpu().numpy()
        tab_s = tab.clone()
        out = torch.empty((ops.N_OUT, n_staged), dtype=torch.int32,
                          device=dev)
        call = lambda: ops.paxos_propose_staged(tab_s, staged, params,
                                                SESSIONS, out=out,
                                                coords=coords)
        event_ms = cuda_ms(torch, call, 20, inner=50)
        device_ms = kernel_device_ms(torch, call, 200,
                                     "paxos_propose_staged_kernel")
        rows = len(set(coords[0].tolist()))
        n_bytes = (n_staged * (8 + 52 + 4 * PROPOSE_TAB_READ
                               + 4 * ops.N_CHG + 4 * ops.N_OUT)
                   + 4 * 4 * rows)
        ops_t = PROPOSE_OPS_PER_LANE * n_staged / INT32_OPS_PER_S
        bound_ms = max(n_bytes / HBM_BYTES_PER_S, ops_t) * 1e3
        ms = device_ms if device_ms is not None else event_ms
        log(f"[time] paxos_propose_staged at {n_staged} of {M}x{SESSIONS} "
            f"lanes in {order} order: kernel {ms:.6f} ms "
            f"({'profiler' if device_ms is not None else 'cuda events'}; "
            f"{event_ms:.6f} ms a wrapper call by cuda events), bound "
            f"{bound_ms:.6f} ms (bytes, {n_bytes} B), "
            f"{ms / bound_ms:.1f}x the bound")
    phase_issuer_waves(torch, mods, rep, dev)


def phase_issuer_waves(torch, mods, rep, dev, n_staged=19, waves=200):
    """The whole-stack issuer wave against the staged wave, in turns (old,
    new, new, old) on one card, each at ``n_staged`` lanes of a 5 x 800
    stack, as host-clock microseconds a wave (each ends in its download);
    then one profiled pass of 50 staged waves, which must show exactly one
    upload, one staged kernel and one download a wave."""
    import numpy as np

    ce, pv = mods.cluster_engine, mods.pv
    idx, staged, coords = staged_inputs(torch, rep, M, SESSIONS, n_staged,
                                        11, dev)
    s_mi, s_lane = coords[0].tolist(), coords[1].tolist()
    replies = staged[2:].cpu().numpy()
    eng = ce.ClusterEngine(mods.ProtocolConfig(
        n_machines=M, sessions_per_machine=SESSIONS), M, device=dev)
    params = eng._params()
    # the whole-stack wave as the engine ran it before the staged entry,
    # then the later pull
    stack = ce.PlaneStack(pv.ProposerTable._fields, pv.TABLE_DEFAULTS, M,
                          SESSIONS, device=dev)
    stage = torch.zeros((13, M, SESSIONS), dtype=torch.int32, device=dev)
    stage[0] = -1
    idle_col = stage[:, 0, :1].clone()
    act_host = np.empty((14, M, SESSIONS), np.int32)

    def old_wave():
        tab_dev = stack.push()
        mi_t, lane_t, vals_t = ce._coords(s_mi, s_lane, replies, dev)
        stage[:, mi_t, lane_t] = vals_t
        out_tab, out_act = ce._fused_issuer_step(
            tab_dev, stage, params, out=stack.out_buffer())
        stage[:, mi_t, lane_t] = idle_col
        stack.absorb(out_tab, mi_t, lane_t)
        act_host[:, s_mi, s_lane] = out_act[:, mi_t, lane_t].cpu().numpy()
        stack.pull()

    def new_wave():
        eng.issuer_wave(s_mi, s_lane, replies)

    def turn(fn):
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(waves):
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e6)
        return out

    times = {"old": [], "new": []}
    for name in ("old", "new", "new", "old"):
        times[name] += turn(old_wave if name == "old" else new_wave)
    old_us, new_us = (statistics.median(times[k]) for k in ("old", "new"))
    log(f"[time] issuer wave at {n_staged} of {M}x{SESSIONS} lanes, host "
        f"clock, turns old/new/new/old x {waves} waves: whole-stack wave "
        f"(coords, scatter, whole-stack step, reset, gather, pull) "
        f"{old_us:.1f} us, staged wave {new_us:.1f} us (medians; "
        f"{old_us - new_us:.1f} us less a wave)")

    rows, _ = profile_device(torch, lambda: [new_wave() for _ in range(50)])
    dev_rows = [r for r in rows if _is_device_row(r) and _device_us(r) > 0]
    for r in dev_rows:
        log(f"[time]   staged waves x50: {r.count:4d} x {r.key[:80]} "
            f"({_device_us(r) / r.count:.3f} us each)")
    counts = {"HtoD": 0, "kernel": 0, "DtoH": 0}
    for r in dev_rows:
        kind = ("HtoD" if "HtoD" in r.key else "DtoH" if "DtoH" in r.key
                else "kernel" if "paxos_propose_staged_kernel" in r.key
                else r.key)
        counts[kind] = counts.get(kind, 0) + r.count
    if counts != {"HtoD": 50, "kernel": 50, "DtoH": 50}:
        raise AssertionError(f"50 staged issuer waves ran device operations "
                             f"{counts}, not one upload, one kernel and one "
                             f"download a wave")
    log("[time] staged issuer wave: 1 HtoD copy, 1 "
        "paxos_propose_staged_kernel, 1 DtoH copy a wave")


# ---------------------------------------------------------------------------
# the model-serving path: flash attention, Mamba2 SSD and RWKV6 WKV
# ---------------------------------------------------------------------------

# H100 SXM peaks used for the float kernels' bounds (NVIDIA data sheet):
# dense bf16 tensor-core rate, the float32 rate of the CUDA cores, and the
# HBM3 rate above.
BF16_FLOPS_PER_S = 989e12
F32_CUDA_CORE_FLOPS_PER_S = 67e12

# kernel vs plain tolerance over unit-normal inputs.  Attention: every
# element within atol + rtol * |plain| with atol = rtol = the figure, as
# tests/test_kernels_attention.py:35 holds bf16 (both round the
# probabilities to bf16 before the value product, the kernel against its
# running maximum and the plain version against the row's: one bf16 ulp of
# an output above 4 is 0.031).  The SSD, the WKV, and the recorded calls of
# the models, against max |plain output|.
FLOAT_TOL = {"float32": 1e-4, "bfloat16": 2e-2}

# (label, B, Hq, Hkv, Sq, Sk, D, causal, window)
FA_CASES = [
    ("zamba2 shared attention", 1, 32, 32, 4096, 4096, 112, True, None),
    ("gemma3-12b local", 1, 16, 8, 2048, 2048, 256, True, 1024),
    ("qwen1.5-4b ragged", 2, 20, 20, 1000, 1000, 128, True, None),
    ("one query, Sk 777", 1, 8, 8, 1, 777, 128, True, None),
    ("Sq < Sk", 1, 8, 8, 300, 1000, 128, True, None),
    ("non-causal", 1, 20, 20, 1500, 1500, 64, False, None),
    ("MQA", 1, 8, 1, 512, 512, 128, True, None),
    ("window straddles key tiles", 1, 8, 8, 129, 129, 112, True, 70),
]
# (label, B, T, H, P, G, N)
SSD_CASES = [
    ("zamba2 Mamba2 layer", 1, 4096, 112, 64, 1, 64),
    ("T=1", 1, 1, 112, 64, 1, 64),
    ("T=127", 1, 127, 112, 64, 1, 64),
    ("T=1000", 1, 1000, 112, 64, 1, 64),
    ("G=2", 1, 512, 16, 64, 2, 64),
    ("T=65, ragged by one chunk step", 1, 65, 112, 64, 1, 64),
    ("T=4097, ragged by one chunk step", 1, 4097, 112, 64, 1, 64),
    ("N=128, the largest state", 1, 1000, 16, 64, 2, 128),
]
# (label, B, H, T, K, V, decays): see wkv_inputs
WKV_CASES = [
    ("rwkv6-7b prefill", 1, 64, 4096, 64, 64, "moderate"),
    ("smoke config", 2, 4, 37, 32, 32, "moderate"),
    ("T=1", 1, 64, 1, 64, 64, "moderate"),
    ("T=127", 1, 64, 127, 64, 64, "moderate"),
    ("T=1000", 1, 64, 1000, 64, 64, "moderate"),
    ("ragged V", 1, 64, 300, 64, 48, "moderate"),
    ("B=2", 2, 64, 256, 64, 64, "moderate"),
    ("T=65, ragged by one chunk step", 1, 64, 65, 64, 64, "moderate"),
    ("T=4097, ragged by one chunk step", 1, 64, 4097, 64, 64, "moderate"),
    ("K=40", 1, 64, 1000, 40, 64, "moderate"),
    ("strong decays, exact zeros", 1, 64, 1000, 64, 64, "strong"),
    ("w=1 over 4096 steps", 1, 64, 4096, 64, 64, "one"),
]
ZAMBA = "zamba2-7b"
RWKV = "rwkv6-7b"
PROMPT_LEN, PROMPT_BATCH = 128, 2
GEN_SESSIONS, GEN_STEPS = 4, 32
PREFILL_SEQ = 4096
# the float kernels: the ops module's attribute in ``mods``, the name under
# which both the ops module and models/blocks.py hold the wrapper, and the
# plain version's name in the ops module
FLOAT_KERNELS = {
    "flash_attention": ("fa_ops", "flash_attention", "attention_plain"),
    "mamba2_ssd": ("ssd_ops", "ssd", "ssd_plain"),
    "rwkv6_wkv": ("wkv_ops", "wkv6", "wkv6_plain")}


class FloatAgreement:
    """Accumulated kernel-vs-plain comparison of one float kernel."""

    def __init__(self):
        self.max_abs_err = 0.0
        self.max_rel_err = 0.0
        self.compared = 0

    def add(self, got, want, tol, what, relative=False):
        got, want = got.float(), want.float()
        if not bool(got.isfinite().all()):
            raise AssertionError(f"{what}: the kernel wrote non-finite values")
        abs_err = float((got - want).abs().max()) if got.numel() else 0.0
        scale = float(want.abs().max()) if want.numel() else 1.0
        rel_err = abs_err / max(scale, 1e-30)
        self.max_abs_err = max(self.max_abs_err, abs_err)
        self.max_rel_err = max(self.max_rel_err, rel_err)
        self.compared += got.numel()
        if relative:
            err = rel_err
        else:             # allclose: max(|got - want| - tol |want|) <= tol
            err = float(((got - want).abs() - tol * want.abs()).max()) \
                if got.numel() else 0.0
        log(f"[kernels] {what}: max abs err {abs_err:.3e}, relative to "
            f"max|plain| {rel_err:.3e} (tolerance {tol:g}"
            f"{' relative to max|plain|' if relative else ' + ' + format(tol, 'g') + ' |plain|'})")
        if not err <= tol:
            raise AssertionError(f"{what}: error {err:.3e} above {tol:g}")


def _dtype(torch, name):
    return getattr(torch, name)


def fa_inputs(torch, case, dtype, seed, dev):
    _, b, hq, hkv, sq, sk, d, causal, window = case
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, hq, sq, d), generator=g, device=dev).to(dtype)
    k = torch.randn((b, hkv, sk, d), generator=g, device=dev).to(dtype)
    v = torch.randn((b, hkv, sk, d), generator=g, device=dev).to(dtype)
    return (q, k, v), dict(causal=causal, window=window)


def ssd_inputs(torch, case, dtype, seed, dev):
    _, b, t, h, p, g_, n = case
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, t, h, p), generator=g, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((b, t, h), generator=g, device=dev)).to(dtype)
    A = -torch.exp(torch.randn((h,), generator=g, device=dev))
    Bm = torch.randn((b, t, g_, n), generator=g, device=dev).to(dtype)
    Cm = torch.randn((b, t, g_, n), generator=g, device=dev).to(dtype)
    return x, dt, A, Bm, Cm


def wkv_inputs(torch, case, dtype, seed, dev):
    """Unit-normal r, k, v, u; decays exp(-exp(x)) as the model makes them,
    by the case's regime: x uniform on [-6, 1] ("moderate", 0.066 ..
    0.9975: near 1 the state carries farthest), on [-1, 5] ("strong":
    about 6 % underflow to exactly 0), or w = 1 exactly ("one": the state
    never decays and grows largest)."""
    _, b, h, t, k, v, regime = case
    g = torch.Generator(device=dev).manual_seed(seed)
    r = torch.randn((b, h, t, k), generator=g, device=dev).to(dtype)
    kk = torch.randn((b, h, t, k), generator=g, device=dev).to(dtype)
    vv = torch.randn((b, h, t, v), generator=g, device=dev).to(dtype)
    if regime == "one":
        w = torch.ones((b, h, t, k), device=dev, dtype=dtype)
    else:
        lo, hi = {"moderate": (-6.0, 1.0), "strong": (-1.0, 5.0)}[regime]
        x = torch.rand((b, h, t, k), generator=g, device=dev) * (hi - lo) + lo
        w = torch.exp(-torch.exp(x)).to(dtype)
    u = torch.randn((h, k), generator=g, device=dev)
    return r, kk, vv, w, u


def phase_model_kernels(torch, mods, dev):
    agree = {name: FloatAgreement() for name in FLOAT_KERNELS}
    for i, case in enumerate(FA_CASES):
        for dname in ("float32", "bfloat16"):
            args, kw = fa_inputs(torch, case, _dtype(torch, dname), 300 + i,
                                 dev)
            got = mods.fa_ops.flash_attention(*args, **kw)
            want = mods.fa_ops.attention_plain(*args, **kw)
            torch.cuda.synchronize()
            agree["flash_attention"].add(
                got, want, FLOAT_TOL[dname],
                f"flash_attention {case[0]} {tuple(case[1:7])} "
                f"causal={case[7]} window={case[8]} {dname}")
            del args, got, want
    for i, case in enumerate(SSD_CASES):
        for dname in ("float32", "bfloat16"):
            args = ssd_inputs(torch, case, _dtype(torch, dname), 400 + i, dev)
            got = mods.ssd_ops.ssd(*args)
            want = mods.ssd_ops.ssd_plain(*args)
            torch.cuda.synchronize()
            agree["mamba2_ssd"].add(
                got, want, FLOAT_TOL[dname],
                f"mamba2_ssd {case[0]} {tuple(case[1:])} {dname}",
                relative=True)
            del args, got, want
    for i, case in enumerate(WKV_CASES):
        for dname in ("float32", "bfloat16"):
            args = wkv_inputs(torch, case, _dtype(torch, dname), 500 + i, dev)
            got = mods.wkv_ops.wkv6(*args)
            want = mods.wkv_ops.wkv6_plain(*args)
            torch.cuda.synchronize()
            agree["rwkv6_wkv"].add(
                got, want, FLOAT_TOL[dname],
                f"rwkv6_wkv {case[0]} (B, H, T, K, V) = {tuple(case[1:6])} "
                f"{case[6]} decays {dname}", relative=True)
            del args, got, want
    torch.cuda.empty_cache()
    return agree


def _describe(model) -> str:
    """``81 layers (13 x 6 mamba + shared attention + 3 tail)``."""
    cfg = model.cfg
    unit = "+".join(sorted(set(model.unit)))
    shared = " + shared attention" if cfg.family == "hybrid" else ""
    return (f"{cfg.n_layers} layers ({model.repeats} x {len(model.unit)} "
            f"{unit}{shared} + {len(model.tail)} tail)")


def _model_params(torch, model, dtype, dev, seed, tag):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = model.init(gen, dtype, dev)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    log(f"[{tag}] {model.cfg.name}: {_describe(model)}, d_model "
        f"{model.cfg.d_model}, {n} parameters, "
        f"{n * params['embed'].element_size() / 1e9:.2f} GB {dtype} on "
        f"{params['embed'].device}, drawn in "
        f"{time.perf_counter() - t0:.2f} s")
    return params


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _wrapper(mods, name):
    ops, attr, _ = FLOAT_KERNELS[name]
    return getattr(getattr(mods, ops), attr)


def _plain(mods, name):
    ops, _, attr = FLOAT_KERNELS[name]
    return getattr(getattr(mods, ops), attr)


def expected_launches(model):
    """Float-kernel launches of one prefill: one flash attention per
    attention layer and shared-block call, one SSD per Mamba2 layer, one
    WKV per RWKV6 layer."""
    kinds = list(model.unit) * model.repeats + list(model.tail)
    shared = model.repeats if model.cfg.family == "hybrid" else 0
    return {"flash_attention": shared + sum(k not in ("mamba", "rwkv")
                                            for k in kinds),
            "mamba2_ssd": kinds.count("mamba"),
            "rwkv6_wkv": kinds.count("rwkv")}


def _prefill_counted(torch, mods, model, params, tokens, recorders=None):
    """One prefill with every float kernel's count set to 0 just before it
    and read just after; optionally through call recorders."""
    recorders = recorders or {}
    for name in FLOAT_KERNELS:
        _wrapper(mods, name).launches = 0
    for name, rec in recorders.items():
        setattr(mods.blocks, FLOAT_KERNELS[name][1], rec)
    try:
        logits = model.prefill(params, tokens)
        torch.cuda.synchronize()
    finally:
        for name in recorders:
            setattr(mods.blocks, FLOAT_KERNELS[name][1],
                    _wrapper(mods, name))
    launches = {name: _wrapper(mods, name).launches for name in FLOAT_KERNELS}
    want = expected_launches(model)
    if launches != want:
        raise AssertionError(f"prefill launched {launches}, expected {want} "
                             f"(one flash attention an attention call, one "
                             f"SSD a Mamba2 layer, one WKV an RWKV6 layer)")
    return logits, launches


def phase_model(torch, mods, dev, name, keep, agree):
    """Full-width ``name`` in float32: prefill (the float kernels' main
    path, through recorders keeping the calls ``keep[kernel]``) against
    its teacher-forced decode, then the Paxos-routed engine."""
    tag = name.split("-")[0]
    cfg = mods.ARCHS[name]
    model = mods.build_model(cfg)
    params = _model_params(torch, model, torch.float32, dev, 0, tag)
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(1, cfg.vocab, (PROMPT_BATCH, PROMPT_LEN),
                           generator=gen, device=dev, dtype=torch.int32)
    recs = {k: Recorder(torch, _wrapper(mods, k), calls)
            for k, calls in keep.items()}
    t0 = time.perf_counter()
    logits, launches = _prefill_counted(torch, mods, model, params, tokens,
                                        recs)
    t_prefill = time.perf_counter() - t0
    log(f"[{tag}] main-path launches of one prefill "
        f"({PROMPT_BATCH} x {PROMPT_LEN} tokens, float32): "
        f"{json.dumps(launches)}; {t_prefill:.3f} s with recording")
    if tuple(logits.shape) != (PROMPT_BATCH, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)} are "
                             f"not finite [{PROMPT_BATCH}, {cfg.vocab}]")

    # recorded prefill calls replayed through the plain versions
    for k, rec in recs.items():
        for i, ins, kw, outs in rec.samples:
            agree[k].add(outs[0], _plain(mods, k)(*ins, **kw),
                         FLOAT_TOL["float32"],
                         f"recorded prefill {k} call {i} "
                         f"{tuple(ins[0].shape)}", relative=True)
        if len(rec.samples) != len(keep[k]):
            raise AssertionError(f"{k}: recorded {len(rec.samples)} calls, "
                                 f"expected {len(keep[k])}")
    del recs

    # teacher-forced decode over the same tokens: kernel-free, plain torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    caches = model.init_cache(PROMPT_BATCH, PROMPT_LEN, dtype=torch.float32,
                              device=dev)
    for t in range(PROMPT_LEN):
        dec, caches = model.decode_step(params, caches, tokens[:, t:t + 1])
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    step_caches = model.init_cache(PROMPT_BATCH, PROMPT_LEN,
                                   dtype=torch.float32, device=dev)
    rows, step_ms = profile_device(torch, lambda: model.decode_step(
        params, step_caches, tokens[:, :1]))
    dev_rows = [r for r in rows if _is_device_row(r) and _device_us(r) > 0]
    step_dev = sum(_device_us(r) for r in dev_rows) / 1e3
    log(f"[{tag}] one float32 decode step profiled: wall {step_ms:.2f} ms, "
        f"device busy {step_dev:.2f} ms over "
        f"{sum(r.count for r in dev_rows)} device ops")
    for r in sorted(dev_rows, key=_device_us, reverse=True)[:6]:
        log(f"[{tag}]   {_device_us(r) / 1e3:9.3f} ms  x{r.count:<5d} "
            f"{r.key[:90]}")
    del step_caches
    scale = float(logits.abs().max())
    err = float((dec - logits).abs().max())
    top_p, top_d = logits.argmax(-1), dec.argmax(-1)
    log(f"[{tag}] prefill vs teacher-forced decode ({PROMPT_LEN} steps, "
        f"{t_decode:.2f} s): max abs logit err {err:.3e}, relative "
        f"{err / scale:.3e} (tolerance 1e-3), top-1 "
        f"{top_p.tolist()} vs {top_d.tolist()}")
    if not (err / scale <= 1e-3 and torch.equal(top_p, top_d)):
        raise AssertionError("prefill and teacher-forced decode disagree")
    del caches, dec

    # DecodeEngine: routes through PaxosRegistry over BatchedMachine
    mods.apply_ops.paxos_apply.launches = 0
    mods.propose_ops.paxos_propose.launches = 0
    t0 = time.perf_counter()
    registry = mods.PaxosRegistry(
        n_machines=5, all_aboard=True,
        machine_cls=functools.partial(mods.BatchedMachine, device=dev))
    engines = [mods.DecodeEngine(model, params,
                                 mods.ServeConfig(max_seq=64),
                                 registry, replica_id=r, device=dev)
               for r in range(2)]
    sessions = list(range(101, 101 + GEN_SESSIONS))
    routes = {s: engines[s % 2].route(s) for s in sessions}
    for s in sessions:
        if not engines[0].route(s) == engines[1].route(s) == routes[s]:
            raise AssertionError(f"session {s}: routes are not sticky")
    t_route = time.perf_counter() - t0
    paxos = {"paxos_apply": mods.apply_ops.paxos_apply.launches,
             "paxos_propose": mods.propose_ops.paxos_propose.launches}
    rng = mods.np.random.default_rng(2)
    prompts = [[int(v) for v in rng.integers(1, cfg.vocab,
                                             int(rng.integers(5, 21)))]
               for _ in sessions]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = engines[0].generate(prompts, steps=GEN_STEPS)
    t_gen = time.perf_counter() - t0
    if out.shape != (GEN_SESSIONS, GEN_STEPS) or out.min() < 0 or \
            out.max() >= cfg.vocab:
        raise AssertionError(f"generate returned {out.shape} tokens outside "
                             f"[0, {cfg.vocab})")
    log(f"[{tag}] routes {routes} sticky across 2 engines "
        f"({t_route:.2f} s, Paxos kernel launches {json.dumps(paxos)}); "
        f"generate {GEN_SESSIONS} sessions (prompts "
        f"{[len(p) for p in prompts]} tokens) x {GEN_STEPS} steps in "
        f"{t_gen:.2f} s; first row {out[0].tolist()}")
    del engines, registry, params
    torch.cuda.empty_cache()
    return launches


def _kernel_group(key: str) -> str:
    """A profiler row's group: every CUDA kernel of a float kernel's wrapper
    carries ``<name>_kernel`` in its name (``flash_attention_kernel_mma``,
    ``flash_attention_kernel_f32``, ...), whatever else a design launches."""
    for name in FLOAT_KERNELS:
        if f"{name}_kernel" in key:
            return f"{name}_kernel"
    if any(w in key.lower() for w in ("gemm", "xmma", "cutlass", "sm90",
                                      "nvjet")):
        return "matmul (cuBLAS)"
    return "other torch kernels"


def phase_prefill_bf16(torch, mods, dev, name):
    """bfloat16 prefill of ``name`` at 1 x PREFILL_SEQ tokens: wall time,
    one profiled pass, and its float kernels' device time per launch."""
    cfg = mods.ARCHS[name]
    model = mods.build_model(cfg)
    params = _model_params(torch, model, torch.bfloat16, dev, 0, "prefill")
    gen = torch.Generator(device=dev).manual_seed(3)
    tokens = torch.randint(1, cfg.vocab, (1, PREFILL_SEQ), generator=gen,
                           device=dev, dtype=torch.int32)
    torch.cuda.reset_peak_memory_stats()
    logits, launches = _prefill_counted(torch, mods, model, params, tokens)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{name} bf16 prefill logits are not finite")
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(params, tokens)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = statistics.median(walls)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for k in FLOAT_KERNELS:
        _wrapper(mods, k).launches = 0
    rows, prof_ms = profile_device(torch, lambda: model.prefill(params,
                                                                tokens))
    # wrapper calls over the profiled pass: a design may launch several
    # CUDA kernels a call, so a call's time is its group's time over these
    prof_calls = {k: _wrapper(mods, k).launches for k in FLOAT_KERNELS}
    dev_rows = [r for r in rows if _is_device_row(r) and _device_us(r) > 0]
    dev_ms = sum(_device_us(r) for r in dev_rows) / 1e3
    log(f"[prefill] {name} bf16 1 x {PREFILL_SEQ} tokens: "
        f"{json.dumps(launches)} launches; wall {wall_ms:.2f} ms (median of "
        f"3: {', '.join(f'{w:.2f}' for w in walls)}), profiled wall "
        f"{prof_ms:.2f} ms, device busy {dev_ms:.2f} ms (busy share "
        f"{dev_ms / prof_ms:.4f}), peak memory {peak_gb:.2f} GB")
    groups = {}
    for r in dev_rows:
        g = _kernel_group(r.key)
        t_ms, cnt = groups.get(g, (0.0, 0))
        groups[g] = (t_ms + _device_us(r) / 1e3, cnt + r.count)
    for g, (t_ms, cnt) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"[prefill]   {t_ms:10.3f} ms  x{cnt:<6d} {g} "
            f"({t_ms / dev_ms:.3f} of device time)")
    for r in sorted(dev_rows, key=_device_us, reverse=True)[:10]:
        log(f"[prefill]     {_device_us(r) / 1e3:9.3f} ms  x{r.count:<5d} "
            f"{r.key[:100]}")
    per_launch = {}
    for k in FLOAT_KERNELS:
        t_ms, cnt = groups.get(f"{k}_kernel", (0.0, 0))
        if cnt and prof_calls[k]:
            per_launch[k] = t_ms / prof_calls[k]
            log(f"[prefill]   {k}: {prof_calls[k]} wrapper calls, {cnt} CUDA "
                f"kernels, {per_launch[k]:.6f} ms a call")
    del params, logits
    torch.cuda.empty_cache()
    return dict(wall_ms=wall_ms, device_ms=dev_ms, launches=launches,
                per_launch_ms=per_launch)


def fa_visible_pairs(sq, sk, causal, window):
    """(query, key) pairs the mask leaves visible, per (batch, head)."""
    import numpy as np
    qpos = np.arange(sq, dtype=np.int64) + (sk - sq)
    hi = np.minimum(qpos, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(qpos - window + 1, 0) if window is not None \
        else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def phase_model_timings(torch, mods, dev, prefill_per_launch):
    """Each float kernel at its model's prefill shape in bf16 (CUDA
    events, median after warm-up), its bound, its plain version and the
    library call.  The kernel's time is the profiler's device time per
    launch in the bf16 prefill (``prefill_per_launch``, same shapes, the
    model's own inputs) where the profiler saw it, else the event time."""
    F = torch.nn.functional
    out = {}
    case = FA_CASES[0]
    (q, k, v), kw = fa_inputs(torch, case, torch.bfloat16, 7, dev)
    _, b, hq, hkv, sq, sk, d, causal, window = case
    call = lambda: mods.fa_ops.flash_attention(q, k, v, **kw)
    pairs = fa_visible_pairs(sq, sk, causal, window)
    out["flash_attention"] = dict(
        shape=f"(B, Hq, S, D) = ({b}, {hq}, {sq}, {d}) causal bf16",
        event_ms=cuda_ms(torch, call, 10),
        device_ms=prefill_per_launch.get("flash_attention"),
        plain_ms=cuda_ms(torch, lambda: mods.fa_ops.attention_plain(
            q, k, v, **kw), 3, warmup=1),
        # a yardstick only: the port never calls it
        library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), 10),
        flops=4 * d * pairs * b * hq,
        bytes=(2 * b * hq * sq + 2 * b * hkv * sk) * d * 2)
    qf, kf, vf = (t.float() for t in (q, k, v))
    f32_ms = cuda_ms(torch, lambda: mods.fa_ops.flash_attention(
        qf, kf, vf, **kw), 5)
    log(f"[time] flash_attention float32 at the same shape: {f32_ms:.4f} ms "
        f"a wrapper call (cuda events)")
    del q, k, v, qf, kf, vf

    case = SSD_CASES[0]
    x, dt, A, Bm, Cm = ssd_inputs(torch, case, torch.bfloat16, 8, dev)
    _, b, t, h, p, g, n = case
    call = lambda: mods.ssd_ops.ssd(x, dt, A, Bm, Cm)
    out["mamba2_ssd"] = dict(
        shape=f"(B, T, H, P, G, N) = ({b}, {t}, {h}, {p}, {g}, {n}) bf16",
        event_ms=cuda_ms(torch, call, 20),
        device_ms=prefill_per_launch.get("mamba2_ssd"),
        plain_ms=cuda_ms(torch, lambda: mods.ssd_ops.ssd_plain(
            x, dt, A, Bm, Cm), 2, warmup=1),
        library_ms=None,
        # per (b, t, h): decay * S + B (dt x) and C^T S over N x P, dt x
        flops=(5 * n * p + p) * b * t * h,
        bytes=(2 * b * t * h * p + b * t * h + 2 * b * t * g * n) * 2
        + 4 * h)
    xf, dtf, Bf, Cf = (a.float() for a in (x, dt, Bm, Cm))
    f32_ms = cuda_ms(torch, lambda: mods.ssd_ops.ssd(xf, dtf, A, Bf, Cf), 10)
    log(f"[time] mamba2_ssd float32 at the same shape: {f32_ms:.4f} ms a "
        f"wrapper call (cuda events)")
    del x, dt, A, Bm, Cm, xf, dtf, Bf, Cf

    case = WKV_CASES[0]
    r, kk, vv, w, u = wkv_inputs(torch, case, torch.bfloat16, 9, dev)
    _, b, h, t, dk, dv, _ = case
    call = lambda: mods.wkv_ops.wkv6(r, kk, vv, w, u)
    out["rwkv6_wkv"] = dict(
        shape=f"(B, H, T, K, V) = ({b}, {h}, {t}, {dk}, {dv}) bf16",
        event_ms=cuda_ms(torch, call, 20),
        device_ms=prefill_per_launch.get("rwkv6_wkv"),
        plain_ms=cuda_ms(torch, lambda: mods.wkv_ops.wkv6_plain(
            r, kk, vv, w, u), 2, warmup=1),
        # no single PyTorch call computes the recurrence
        library_ms=None,
        # per (b, h, t): k v^T, u (k v^T), S + that, times r, the sum over
        # K, then w S + k v^T: 7 K V
        flops=7 * dk * dv * b * h * t,
        bytes=(3 * b * h * t * dk + 2 * b * h * t * dv) * 2 + 4 * h * dk)
    f32 = [a.float() for a in (r, kk, vv, w)]
    f32_ms = cuda_ms(torch, lambda: mods.wkv_ops.wkv6(*f32, u), 10)
    log(f"[time] rwkv6_wkv float32 at the same shape: {f32_ms:.4f} ms a "
        f"wrapper call (cuda events); the sequential form on the float32 "
        f"CUDA cores needs at least "
        f"{out['rwkv6_wkv']['flops'] / F32_CUDA_CORE_FLOPS_PER_S * 1e3:.4f}"
        f" ms (67 TFLOP/s)")
    del r, kk, vv, w, u, f32

    for name, r in out.items():
        r["ms"] = r["device_ms"] if r["device_ms"] is not None \
            else r["event_ms"]
        r["ms_source"] = ("profiler, bf16 prefill"
                          if r["device_ms"] is not None else "cuda events")
        t_ops = r["flops"] / BF16_FLOPS_PER_S
        t_bytes = r["bytes"] / HBM_BYTES_PER_S
        r["bound_ms"] = max(t_ops, t_bytes) * 1e3
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.6f} ms")
        log(f"[time] {name} {r['shape']}: kernel {r['ms']:.6f} ms "
            f"({r['ms_source']}; {r['event_ms']:.6f} ms a wrapper call by "
            f"cuda events), bound {r['bound_ms']:.6f} ms ({r['bound_by']}: "
            f"{r['flops']} flop, {r['bytes']} B; "
            f"{r['flops'] / r['ms'] / 1e9:.2f} TFLOP/s, "
            f"{r['bytes'] / r['ms'] / 1e6:.1f} GB/s achieved, "
            f"{r['ms'] / r['bound_ms']:.2f}x the bound), plain "
            f"{r['plain_ms']:.6f} ms, library {lib}")
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

    import numpy as np

    from repro_torch.configs.archs import ARCHS
    from repro_torch.coord.registry import PaxosRegistry
    from repro_torch.core import checkers
    from repro_torch.core import proposer_vector as pv
    from repro_torch.core.lanes import kv_to_lanes
    from repro_torch.core.node import Machine, ProtocolConfig
    from repro_torch.core.sim import Cluster, NetConfig, completion_digest, \
        completion_tuples, workload
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mamba2_ssd import ops as ssd_ops
    from repro_torch.kernels.paxos_apply import ops as apply_ops
    from repro_torch.kernels.paxos_propose import ops as propose_ops
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
    from repro_torch.models import blocks
    from repro_torch.models.registry import build_model
    from repro_torch.obs import FlightRecorder, flight_guard
    from repro_torch.reconfig import catchup
    from repro_torch.serve import loadgen
    from repro_torch.serve.engine import DecodeEngine, ServeConfig
    from repro_torch.serve.paxos import BatchedMachine, cluster_engine

    mods = argparse.Namespace(
        checkers=checkers, Machine=Machine, ProtocolConfig=ProtocolConfig,
        Cluster=Cluster, NetConfig=NetConfig,
        completion_tuples=completion_tuples,
        completion_digest=completion_digest, workload=workload,
        kv_to_lanes=kv_to_lanes,
        apply_ops=apply_ops, propose_ops=propose_ops,
        BatchedMachine=BatchedMachine, cluster_engine=cluster_engine,
        np=np, pv=pv, ARCHS=ARCHS, PaxosRegistry=PaxosRegistry,
        blocks=blocks,
        build_model=build_model, fa_ops=fa_ops, ssd_ops=ssd_ops,
        wkv_ops=wkv_ops, DecodeEngine=DecodeEngine, ServeConfig=ServeConfig,
        loadgen=loadgen, FlightRecorder=FlightRecorder,
        flight_guard=flight_guard, catchup=catchup)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # float32 products in full float32 (the model checks' tolerances
    # assume it; these are PyTorch's defaults for matmul, not for cuDNN)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    phase_open_loop(torch, mods, dev, apply_ok, propose_ok)
    phase_reconfig(torch, mods, dev, apply_ok, propose_ok)
    float_ok = phase_model_kernels(torch, mods, dev)
    # one full-width model resident at a time: each phase frees its own
    zamba_launches = phase_model(
        torch, mods, dev, ZAMBA,
        {"flash_attention": (0, 6, 12), "mamba2_ssd": (0, 40, 80)}, float_ok)
    prefill = phase_prefill_bf16(torch, mods, dev, ZAMBA)
    rwkv_launches = phase_model(torch, mods, dev, RWKV,
                                {"rwkv6_wkv": (0, 15, 31)}, float_ok)
    rwkv_prefill = phase_prefill_bf16(torch, mods, dev, RWKV)
    times.update(phase_model_timings(
        torch, mods, dev,
        {**prefill["per_launch_ms"], **rwkv_prefill["per_launch_ms"]}))
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
    # each float kernel's launches: its model's main path (the f32 prefill)
    model_launches = {"flash_attention": zamba_launches["flash_attention"],
                      "mamba2_ssd": zamba_launches["mamba2_ssd"],
                      "rwkv6_wkv": rwkv_launches["rwkv6_wkv"]}
    model_sources = {
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:34",
                            "_fa_kernel"),
        "mamba2_ssd": ("src/repro_torch/csrc/mamba2_ssd.cu",
                       "src/repro/kernels/mamba2_ssd/kernel.py:36",
                       "_ssd_kernel"),
        "rwkv6_wkv": ("src/repro_torch/csrc/rwkv6_wkv.cu",
                      "src/repro/kernels/rwkv6_wkv/kernel.py:31",
                      "_wkv6_kernel")}
    for name, (src, replaces, fn) in model_sources.items():
        t, agree = times[name], float_ok[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "replaces_function": fn,
            "launches": model_launches[name],
            "max_abs_err": agree.max_abs_err,
            "max_rel_err": agree.max_rel_err, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
