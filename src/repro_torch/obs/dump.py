"""Deterministic flight-recorder exports + the auto-dump failure guard.

Two formats, both pure functions of the recorder state (no wall clock, no
hostnames — the determinism tests compare dumps byte-for-byte):

* **JSONL** — line 1 a ``meta`` header (run identity + recorder config),
  line 2 a ``metrics`` record (full registry snapshot with raw sources
  synced), then one line per ring record in ring order.  This is the
  format ``scripts/trace_report.py`` consumes.
* **Chrome trace** — the ``traceEvents`` JSON array Perfetto and
  ``chrome://tracing`` load: one complete (``ph: "X"``) event per span,
  ``pid`` = machine, ``tid`` = session, timestamps in virtual ticks
  (microsecond units as far as the viewer is concerned).

:func:`flight_guard` is how smoke scripts and harnesses get postmortems
for free: any exception escaping the block (a
:class:`~repro_torch.core.checkers.SafetyViolation`, an unexpected machine
crash surfacing as a failed equivalence assert, a non-zero ``sys.exit``)
triggers a dump before the exception continues.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
from typing import Dict, Iterator

from .trace import FlightRecorder

_JSON_KW = {"sort_keys": True, "separators": (",", ":")}


def dump_jsonl(recorder: FlightRecorder, path: str) -> str:
    """Write the JSONL dump; returns ``path``.  Byte-deterministic for a
    given (seed, spec, recorder config)."""
    header = {"type": "meta", "mode": recorder.mode,
              "sample_every": recorder.sample_every,
              "capacity": recorder.capacity, "meta": recorder.meta}
    metrics = {"type": "metrics"}
    metrics.update(recorder.snapshot())
    with open(path, "w") as f:
        f.write(json.dumps(header, **_JSON_KW) + "\n")
        f.write(json.dumps(metrics, **_JSON_KW) + "\n")
        for rec in recorder.ring:
            f.write(json.dumps(rec, **_JSON_KW) + "\n")
    return path


def dump_chrome_trace(recorder: FlightRecorder, path: str) -> str:
    """Write the Chrome-trace/Perfetto export of the span timeline."""
    events = []
    for rec in recorder.ring:
        if rec.get("type") == "span" and rec.get("end", -1.0) >= 0:
            events.append({
                "name": f"{rec['kind']}:{rec['path']}",
                "cat": rec["kind"], "ph": "X",
                "ts": rec["start"], "dur": rec["dur"],
                "pid": rec["mid"], "tid": rec["sess"],
                "args": {"key": rec["key"], "tag": rec["tag"],
                         "retries": rec["retries"], "steals": rec["steals"],
                         "helps": rec["helps"],
                         "wait_ticks": rec["wait_ticks"]},
            })
            for t, name in rec.get("events", []):
                events.append({"name": name, "cat": "evt", "ph": "i",
                               "ts": t, "pid": rec["mid"],
                               "tid": rec["sess"], "s": "t"})
        elif rec.get("type") == "event":
            events.append({"name": rec["name"], "cat": "cluster", "ph": "i",
                           "ts": rec.get("t", 0.0),
                           "pid": rec.get("mid", 0), "tid": 0, "s": "g"})
    with open(path, "w") as f:
        json.dump({"traceEvents": events,
                   "displayTimeUnit": "ms", "meta": recorder.meta},
                  f, **_JSON_KW)
    return path


def dump_all(recorder: FlightRecorder, out_dir: str, *,
             reason: str = "", stem: str = "flight") -> Dict[str, str]:
    """Dump both formats into ``out_dir`` (created if missing) under
    deterministic names; returns ``{"jsonl": ..., "trace": ...}``."""
    os.makedirs(out_dir, exist_ok=True)
    if reason:
        recorder.meta["dump_reason"] = reason
    return {
        "jsonl": dump_jsonl(recorder, os.path.join(out_dir, stem + ".jsonl")),
        "trace": dump_chrome_trace(
            recorder, os.path.join(out_dir, stem + ".trace.json")),
    }


@contextlib.contextmanager
def flight_guard(recorder: FlightRecorder, out_dir: str, *,
                 label: str = "failure",
                 stem: str = "flight") -> Iterator[FlightRecorder]:
    """Dump the flight recorder automatically when the guarded block dies.

    Catches every escaping exception — checker :class:`SafetyViolation`,
    equivalence asserts, ``sys.exit(nonzero)`` — dumps, prints the dump
    location to stderr, and re-raises.  A clean ``sys.exit(0)`` does not
    dump.  The CI jobs upload ``out_dir`` as an artifact on failure.
    """
    try:
        yield recorder
    except BaseException as exc:
        if isinstance(exc, SystemExit) and exc.code in (0, None):
            raise
        reason = f"{label}: {type(exc).__name__}: {exc}"
        paths = dump_all(recorder, out_dir, reason=reason, stem=stem)
        print(f"[obs] flight recorder dumped: {paths['jsonl']} "
              f"({reason})", file=sys.stderr)
        raise
