"""Open-loop arrival process and op-class mixes, in seeded virtual time.

**Open loop** means arrival times are a property of the *workload*, not of
the system: the i-th request arrives at its scheduled virtual tick whether
or not earlier requests have completed.  Under overload the backlog (machine
FIFOs, ingest queues) grows and queueing delay lands *in the measured
latency* — which is the honest way to measure tail latency, and the thing
the repo's closed-loop benchmarks (``workload()`` in ``repro_torch.core.sim``,
which enqueues everything up front) cannot show.  See ``docs/workloads.md``
for the methodology.

* :class:`ArrivalPhase` — ``(rate, ticks)``: a Poisson arrival segment at
  ``rate`` expected arrivals per virtual tick lasting ``ticks`` virtual
  ticks.  A sweep is just a tuple of phases (e.g. ramp 0.2 → 0.5 → 1.0
  ops/tick); inter-arrival gaps are exponential draws from a dedicated
  seeded stream, so the whole arrival sequence is a pure function of
  ``(phases, seed)``.

* :class:`OpMix` — per-op-class probabilities (RMW / write / read)
  matching the paper's §2 deployment model (a replicated KV store serving
  all three).  :data:`PRESETS` names the mixes the benchmarks use;
  ``docs/workloads.md`` maps each to its deployment rationale.
"""

from __future__ import annotations

import dataclasses
import random
from typing import List, Sequence, Tuple

from repro_torch.core.node import ReqKind


@dataclasses.dataclass(frozen=True)
class ArrivalPhase:
    """Poisson arrivals at ``rate`` per virtual tick for ``ticks`` ticks."""

    rate: float
    ticks: float

    def __post_init__(self):
        if self.rate <= 0 or self.ticks <= 0:
            raise ValueError(f"phase needs rate > 0 and ticks > 0: {self}")


def arrival_times(phases: Sequence[ArrivalPhase], seed: int) -> List[float]:
    """The full arrival-time sequence (ascending virtual ticks) for a
    phase sweep — exponential inter-arrival gaps, seeded stream."""
    rng = random.Random(f"arrivals:{seed}")
    out: List[float] = []
    t0 = 0.0
    for ph in phases:
        t = t0
        end = t0 + ph.ticks
        while True:
            t += rng.expovariate(ph.rate)
            if t >= end:
                break
            out.append(t)
        t0 = end
    return out


@dataclasses.dataclass(frozen=True)
class OpMix:
    """Op-class probabilities; the read fraction is the remainder."""

    name: str
    rmw: float
    write: float

    def __post_init__(self):
        if self.rmw < 0 or self.write < 0 or self.rmw + self.write > 1.0:
            raise ValueError(f"bad op mix {self}")

    @property
    def read(self) -> float:
        return 1.0 - self.rmw - self.write

    def draw(self, rng: random.Random) -> ReqKind:
        r = rng.random()
        if r < self.rmw:
            return ReqKind.RMW
        if r < self.rmw + self.write:
            return ReqKind.WRITE
        return ReqKind.READ


# The §2 deployment model: a datacenter KV store serving reads, writes and
# RMWs.  The paper gives no traffic ratios, so the presets are the
# conventional KV-store evaluation points (docs/workloads.md maps each to
# its rationale and to which protocol path it stresses).
PRESETS: Tuple[OpMix, ...] = (
    OpMix("read_heavy", rmw=0.02, write=0.08),   # ABD common case (§10–§11)
    OpMix("kv_mixed", rmw=0.10, write=0.20),     # balanced KV front end
    OpMix("update_heavy", rmw=0.30, write=0.30),  # write-back pressure
    OpMix("rmw_only", rmw=1.00, write=0.00),     # the paper's CP/§9 tables
)

MIXES = {m.name: m for m in PRESETS}
