"""Live reconfiguration: membership as a CP-decided config register.

A deployment's membership is a :class:`~repro_torch.core.types.View` (epoch,
member set) stored in a reserved config register
(:data:`~repro_torch.core.types.CONFIG_KEY`).  Changing it needs no new
consensus protocol: a view change is a normal CP RMW (a CAS on the
encoded view) issued through the existing proposer path, in the spirit of
in-place consensus objects (RMWPaxos, Skrzypczak et al.) — the register's
own linearizability makes view changes totally ordered.

The subsystem splits into:

* :mod:`.views` — transition validation (single-member deltas, so
  consecutive views' majority quorums always intersect);
* :mod:`.catchup` — snapshot + replay for joiners (serialize receiver KV
  planes and issuer lanes through :mod:`repro_torch.checkpoint.store`, install
  on the joiner, replay the committed tail before it votes);
* :mod:`.controller` — the controller that reads/CASes the config register
  and spawns/retires machines (`Cluster.join` / `Cluster.leave`).

Fencing is epoch-based: every wire message and reply carries its sender's
epoch, and machines drop cross-epoch traffic (see the fencing rule next
to the wire-kind definitions in :mod:`repro_torch.core.types`).
"""

from .views import joined, left, validate_transition       # noqa: F401
from .catchup import (                                     # noqa: F401
    install_snapshot, load_snapshot, replay_tail, save_snapshot,
    snapshot_equal, take_snapshot,
)
from .controller import ReconfigController                 # noqa: F401
