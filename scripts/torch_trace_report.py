#!/usr/bin/env python
"""Summarise a flight-recorder JSONL dump of the PyTorch/CUDA port.

The port's counterpart of ``scripts/trace_report.py``.  Reads the dump
written by ``repro_torch.obs.dump_jsonl`` / ``dump_all`` (the file a
failed ``torch_*_smoke.py`` seed or checker leaves behind) and prints
what the run's protocol traffic did:

* path mix (ABD read/write, all-aboard fast, CP slow) from the *exact*
  registry counters,
* the fast-path hit rate,
* per-path latency percentiles over the recorded spans (virtual ticks),
* the top contended keys (retries + steals + helps),
* network fault accounting.

Usage::

    python scripts/torch_trace_report.py build/flight_dumps/x.jsonl
    python scripts/torch_trace_report.py --json build/flight_dumps/x.jsonl

The summary is host-side bookkeeping and touches no device, so this
script takes no ``--device``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.obs.report import render_summary, summarize_file  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dump", help="flight-recorder JSONL dump")
    ap.add_argument("--json", action="store_true",
                    help="emit the summary as JSON instead of text")
    args = ap.parse_args(argv)
    summary = summarize_file(args.dump)
    if args.json:
        print(json.dumps(summary, indent=1, sort_keys=True))
    else:
        print(render_summary(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
