"""Checkpoint retention policy: which saved steps survive garbage collection.

``CheckpointPolicy.keep_steps`` is a *pure* function of the save history —
no filesystem access, no clock reads — so retention decisions are
reproducible from manifests alone and property-testable in isolation
(``tests/test_ckpt_lifecycle.py``).  The manager rebuilds the history from
the committed manifests on every GC pass, which makes the policy crash-safe
by construction: there is no in-memory retention state to lose.

Two retention axes, union'd:

* **keep_last** — the newest N steps by step number (the "resume from the
  latest few" window every trainer needs).
* **keep_spaced** — the newest M *time anchors*.  Anchors are chosen
  greedily oldest-first: the first save is an anchor, and each later save
  is an anchor iff its wall time is at least ``spacing_s`` past the
  previous anchor's.  Prefix-stable by construction (appending a save
  never changes which earlier saves are anchors), which is what makes the
  keep-set monotone: ``keep_steps(h + [x]) ⊆ keep_steps(h) ∪ {x.step}``.

The union is then closed under delta-chain base references: a kept delta
checkpoint keeps its base (transitively, down to the full save that roots
the chain).  A chain is one *retention unit* — GC may drop its newest
members, but never a base a surviving delta still needs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence

__all__ = ["SaveInfo", "CheckpointPolicy", "chain_of"]


@dataclass(frozen=True)
class SaveInfo:
    """One committed save, as recorded in its manifest."""

    step: int
    wall_time: float
    kind: str = "full"  # "full" | "delta"
    base: Optional[int] = None  # delta: the step this delta patches


def chain_of(step: int, by_step: Dict[int, SaveInfo]) -> List[int]:
    """The delta chain rooted under ``step``: ``step`` itself plus every
    transitive base, newest first.  Stops (returning the partial chain) if a
    base is missing from the history — validation, not retention, is the
    layer that rejects broken chains."""
    out: List[int] = []
    cur: Optional[int] = step
    while cur is not None and cur in by_step and cur not in out:
        out.append(cur)
        cur = by_step[cur].base
    return out


@dataclass(frozen=True)
class CheckpointPolicy:
    """keep the last ``keep_last`` steps + the newest ``keep_spaced``
    time-anchors spaced ``spacing_s`` seconds apart, closed under
    delta-chain bases."""

    keep_last: int = 3
    keep_spaced: int = 0
    spacing_s: float = 3600.0

    def __post_init__(self):
        if self.keep_last < 0 or self.keep_spaced < 0:
            raise ValueError("keep_last/keep_spaced must be >= 0")
        if self.spacing_s <= 0:
            raise ValueError("spacing_s must be > 0")

    def anchors(self, history: Sequence[SaveInfo]) -> List[int]:
        """Greedy oldest-first time anchors (all of them, not yet capped at
        keep_spaced).  Prefix-stable: anchors(h) is a prefix-closed function
        of h sorted by step."""
        out: List[int] = []
        last_t: Optional[float] = None
        for s in sorted(history, key=lambda s: s.step):
            if last_t is None or s.wall_time - last_t >= self.spacing_s:
                out.append(s.step)
                last_t = s.wall_time
        return out

    def keep_steps(self, history: Sequence[SaveInfo]) -> FrozenSet[int]:
        """The retained step set for ``history`` (order-insensitive; entries
        are keyed by step and deduplicated, newest entry winning)."""
        by_step: Dict[int, SaveInfo] = {s.step: s for s in history}
        if not by_step:
            return frozenset()
        ordered = sorted(by_step)
        keep = set(ordered[-self.keep_last:] if self.keep_last else [])
        if self.keep_spaced:
            anchors = self.anchors(list(by_step.values()))
            keep.update(anchors[-self.keep_spaced:])
        # close under delta-base references: a kept delta pins its chain
        for step in list(keep):
            keep.update(chain_of(step, by_step))
        return frozenset(keep)
