"""The collectives a block of code runs, and their bytes a device.

Port of ``repro.launch.dryrun.collective_bytes``.  The reference parses
the collectives out of the HLO that XLA's SPMD partitioner compiled for a
step, scaling a scanned layer body's by the trip count.  An eager program
has no HLO: the port runs the step, and :class:`CollectiveCounter`, a
``TorchDispatchMode``, records every collective it issues, forward and
backward.  DTensor's redistributes reach it as the functional collectives
(``torch.ops._c10d_functional``: all-gather, all-reduce and reduce-scatter
are the ones the steps issue; a shard-to-shard redistribute is
``_dtensor``'s all-to-all on a card), the shard_map MoE's explicit
all-reduce as ``c10d``'s; :data:`COLLECTIVES` is the one table of them, which
``parallel/host_staged.py`` stages by, and any other op of DTensor's
collective namespaces raises.

Each is counted under the reference's kinds with its result shape's bytes
on one device, the reference's measure (``dryrun.py:76-79``): an
all-gather's whole output, a reduce-scatter's block, an all-reduce's
tensor, an all-to-all's block.  ``count`` is the number of collectives run.  The reference's
``count_static`` (distinct ops in the compiled program, the loop body
once) has no counterpart: an eager program issues each layer's
collectives anew, so ``count`` is the number to read.

The counts are DTensor's, not XLA's: DTensor picks each operator's layout
eagerly, where XLA's partitioner plans the whole step, so a cell's bytes
differ from the reference's (``tests/test_torch_collectives.py`` holds a
single redistribute to the reference's ``collective_bytes``).
"""

from __future__ import annotations

from typing import Dict, Optional

from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

KEYS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute")

# the collectives the port's steps issue (op name without its overload) ->
# the reference's kind: DTensor's redistributes as functional collectives,
# its shard-to-shard redistribute on a card's mesh (the dry run's count,
# ``dryrun.alltoall_as_on_a_card``), and the shard_map MoE's explicit
# all-reduce (``blocks._AllReduceSum``)
COLLECTIVES = {
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_dtensor::shard_dim_alltoall": "all-to-all",
    "c10d::allreduce_": "all-reduce",
}
# the namespaces of DTensor's collectives, and their ops that move nothing
_FUNCTIONAL = ("_c10d_functional", "_c10d_functional_autograd", "_dtensor")
_NOT_COLLECTIVES = frozenset({"_c10d_functional::wait_tensor",
                              "_c10d_functional::_wrap_tensor_autograd"})


def collective_kind(name: str) -> Optional[str]:
    """The reference's kind of op ``name`` (``namespace::name``) if it is
    one of :data:`COLLECTIVES`, else None.  Raises on any other op of
    DTensor's collective namespaces, so that a collective this table does
    not hold is neither counted as nothing nor left unstaged."""
    kind = COLLECTIVES.get(name)
    if (kind is None and name.split("::")[0] in _FUNCTIONAL
            and name not in _NOT_COLLECTIVES):
        raise NotImplementedError(f"{name}: a collective that "
                                  f"launch/collectives.py does not know")
    return kind


def _nbytes(t) -> int:
    if isinstance(t, (list, tuple)):
        return sum(_nbytes(x) for x in t)
    return t.numel() * t.element_size()


class CollectiveCounter(TorchDispatchMode):
    """``with CollectiveCounter() as c: ...`` records every collective the
    block runs on this rank; :meth:`result` gives the reference's dict."""

    def __init__(self):
        super().__init__()
        self.bytes: Dict[str, int] = dict.fromkeys(KEYS, 0)
        self.ops: Dict[str, int] = dict.fromkeys(KEYS, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        # let DTensor turn its op into local ops and collectives first,
        # which then come here on plain (or fake) tensors
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        name = func._schema.name
        kind = collective_kind(name)
        if kind is not None:
            # a functional collective returns its result; c10d's in-place
            # all-reduce returns (its tensors, work)
            self.ops[kind] += 1
            self.bytes[kind] += _nbytes(args[0] if name.startswith("c10d::")
                                        else out)
        return out

    def result(self) -> Dict[str, int]:
        """{kind: bytes a device} for the reference's five kinds, and
        ``count``, the collectives run."""
        return {**self.bytes, "count": sum(self.ops.values())}
