"""View-transition rules.

Safety across a view change rests on quorum intersection between
*consecutive* views: a value decided by a majority of view ``e`` must be
seen by every majority of view ``e+1``.  Restricting transitions to
**single-member deltas** guarantees it arithmetically:

* add (n -> n+1):  (n//2 + 1) + ((n+1)//2 + 1) >= n + 2 > n + 1
* remove (n -> n-1): (n//2 + 1) + ((n-1)//2 + 1) >= n + 1 > n

so any old-view majority and any new-view majority overlap in at least
one machine (whose acceptor state is persistent).  Larger membership
changes are expressed as a chain of single-member view changes, each a
separate CP-decided RMW on the config register.
"""

from __future__ import annotations

from typing import Iterable, Tuple

from repro_torch.core.types import MAX_MEMBERS, View


def validate_transition(cur: View, new_members: Iterable[int]) -> View:
    """Check a proposed membership against the current view; returns the
    candidate next view (epoch + 1) or raises ``ValueError``."""
    members: Tuple[int, ...] = tuple(sorted(set(new_members)))
    if not members:
        raise ValueError("a view must have at least one member")
    if members[0] < 0 or members[-1] >= MAX_MEMBERS:
        raise ValueError(
            f"members {members} outside [0, {MAX_MEMBERS}): machine ids "
            f"must fit the engines' {MAX_MEMBERS}-bit reply bitmaps")
    delta = set(members) ^ set(cur.members)
    if len(delta) != 1:
        raise ValueError(
            f"view change {cur.members} -> {members} is not a "
            f"single-member delta (changed: {sorted(delta)}); chain "
            f"multiple view changes instead")
    return View(cur.epoch + 1, members)


def joined(cur: View, new: View) -> Tuple[int, ...]:
    """Machine ids present in ``new`` but not in ``cur``."""
    return tuple(sorted(set(new.members) - set(cur.members)))


def left(cur: View, new: View) -> Tuple[int, ...]:
    """Machine ids present in ``cur`` but not in ``new``."""
    return tuple(sorted(set(cur.members) - set(new.members)))
