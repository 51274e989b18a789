"""Flight-dump summarizer (the engine behind ``scripts/trace_report.py``).

Input: the JSONL dump written by :func:`repro_torch.obs.dump.dump_jsonl`.
Output: a JSON-ready summary of what the run's protocol traffic actually
did — the numbers the paper's §9–§11 claims are about:

* **path mix** — completions per path, from the *exact* registry counters
  (present even when the span ring was sampled or empty);
* **fast-path hit rate** — ``all_aboard_fast / (all_aboard_fast +
  cp_slow)``: the fraction of RMWs the §9 fast path actually carried;
* **per-path latency percentiles** — from the recorded spans' virtual-time
  durations, via the same :class:`QuantileSketch` accuracy contract as
  the open-loop harness (sampled spans ⇒ sampled percentiles — see the
  sampling contract in ``docs/observability.md``);
* **top contended keys** — keys ranked by contention events
  (retries + steals + helps) observed on their spans: where CP conflict
  resolution actually burned rounds.
"""

from __future__ import annotations

import json
from typing import Dict, List

from repro_torch.serve.loadgen.sketch import QuantileSketch
from .trace import PATHS


def load_records(path: str) -> List[dict]:
    """Read a JSONL dump: list of records (meta header first)."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


def summarize(records: List[dict]) -> dict:
    """Summarize a loaded dump (see module docstring for the fields)."""
    meta: dict = {}
    counters: Dict[str, int] = {}
    spans = []
    events = []
    for rec in records:
        t = rec.get("type")
        if t == "meta":
            meta = rec
        elif t == "metrics":
            counters = rec.get("counters", {})
        elif t == "span":
            spans.append(rec)
        elif t == "event":
            events.append(rec)

    path_mix = {p: counters.get("path." + p, 0) for p in PATHS}
    aborted = counters.get("path.aborted", 0)
    fast = path_mix["all_aboard_fast"]
    slow = path_mix["cp_slow"]
    hit_rate = (fast / (fast + slow)) if (fast + slow) else None

    # per-path latency percentiles over recorded (possibly sampled) spans
    lat: Dict[str, QuantileSketch] = {}
    per_key: Dict[int, dict] = {}
    for sp in spans:
        if sp.get("dur", -1.0) >= 0 and sp.get("path") in PATHS:
            lat.setdefault(sp["path"], QuantileSketch()).record(
                max(sp["dur"], 1.0))
        k = sp.get("key")
        row = per_key.setdefault(
            k, {"key": k, "spans": 0, "retries": 0, "steals": 0,
                "helps": 0, "wait_ticks": 0})
        row["spans"] += 1
        row["retries"] += sp.get("retries", 0)
        row["steals"] += sp.get("steals", 0)
        row["helps"] += sp.get("helps", 0)
        row["wait_ticks"] += sp.get("wait_ticks", 0)

    def contention(row: dict) -> int:
        return row["retries"] + row["steals"] + row["helps"]

    top_keys = sorted((r for r in per_key.values() if contention(r)),
                      key=lambda r: (-contention(r), r["key"]))[:10]

    latency = {}
    for p, sk in sorted(lat.items()):
        latency[p] = {"count": sk.count,
                      "p50": round(sk.quantile(0.50), 3),
                      "p90": round(sk.quantile(0.90), 3),
                      "p99": round(sk.quantile(0.99), 3),
                      "max": round(sk.max, 3)}

    evt_counters = {k[len("evt."):]: v for k, v in sorted(counters.items())
                    if k.startswith("evt.")}
    return {
        "meta": meta.get("meta", {}),
        "mode": meta.get("mode"),
        "dump_reason": meta.get("meta", {}).get("dump_reason"),
        "path_mix": path_mix,
        "aborted": aborted,
        "fast_path_hit_rate": hit_rate,
        "latency": latency,
        "top_contended_keys": top_keys,
        "events": evt_counters,
        "ring_spans": len(spans),
        "ring_events": len(events),
        "net": {k[len("net."):]: v for k, v in sorted(counters.items())
                if k.startswith("net.")},
    }


def render_summary(s: dict) -> str:
    """Human-readable rendering of :func:`summarize` output."""
    lines = []
    meta = s.get("meta") or {}
    head = ", ".join(f"{k}={v}" for k, v in sorted(meta.items()))
    lines.append(f"flight dump summary ({head or 'no meta'})")
    if s.get("dump_reason"):
        lines.append(f"  dumped because: {s['dump_reason']}")
    total = sum(s["path_mix"].values())
    lines.append(f"  path mix ({total} completions"
                 + (f", {s['aborted']} aborted" if s["aborted"] else "")
                 + "):")
    for p in PATHS:
        n = s["path_mix"][p]
        pct = (100.0 * n / total) if total else 0.0
        lines.append(f"    {p:<16} {n:>8}  {pct:5.1f}%")
    hr = s["fast_path_hit_rate"]
    lines.append("  fast-path hit rate: "
                 + (f"{100.0 * hr:.1f}%" if hr is not None else "n/a"))
    if s["latency"]:
        lines.append("  latency (virtual ticks, recorded spans):")
        for p, row in s["latency"].items():
            lines.append(f"    {p:<16} n={row['count']:<6} p50={row['p50']:<8}"
                         f" p90={row['p90']:<8} p99={row['p99']:<8}"
                         f" max={row['max']}")
    if s["top_contended_keys"]:
        lines.append("  top contended keys (retries+steals+helps):")
        for r in s["top_contended_keys"]:
            lines.append(f"    key {r['key']:<8} spans={r['spans']:<6}"
                         f" retries={r['retries']:<5} steals={r['steals']:<5}"
                         f" helps={r['helps']:<5}"
                         f" wait_ticks={r['wait_ticks']}")
    if s["net"]:
        net = ", ".join(f"{k}={v}" for k, v in s["net"].items())
        lines.append(f"  network: {net}")
    return "\n".join(lines)


def summarize_file(path: str) -> dict:
    return summarize(load_records(path))
