"""Online graph re-mining with validated hot-swap.

The miner (:mod:`repro_torch.analysis.mine`) removes the paper's adoption cost
*once*: record a few traces, fold them into a graph, speculate.  But the
mined graph bakes in whatever the application did during observation — fd
numbers, file sizes, loop counts — and a long-lived server drifts: an LSM
compaction rewrites the level layout, a config reload changes a scan
width.  The pre-issuing engine stays *correct* under drift (the harvest
guard refuses stale pre-issues and serves synchronously), but the
speculation benefit silently decays to zero.

:class:`ReMiner` closes the loop online:

1. **Sample** — elect 1-in-``sample_every`` activations of each watched
   endpoint to run serially under a ``RecordingSession``; the trace lands
   in the endpoint's bounded :class:`repro_torch.core.trace.TraceRing`.
2. **Mine + shadow-validate** — every ``remine_every`` sampled traces,
   mine a candidate and replay *all* sampled traces (including a held-out
   one) against it; any mismatch refuses the candidate.
3. **Predicted improvement** — score candidate vs incumbent with
   :func:`repro_torch.analysis.mine.preissue_overlap` on the held-out traces;
   a candidate that does not strictly beat the incumbent's predicted
   pre-issue schedule is refused (no churn for zero gain).
4. **Hot-swap** — :meth:`repro_torch.core.api.Foreactor.swap_graph` replaces
   the builder atomically: in-flight sessions finish on the plan they
   activated with, new sessions build version N+1.
5. **Regression guard** — the first ``guard_sessions`` sessions on the
   new version feed a per-version waste ledger; if their waste rate
   (``cancelled + wasted_completions`` per pre-issue — the *sum* is
   deterministic, the split is worker-timing-dependent) regresses past
   the pre-swap baseline, the guard rolls the swap back and vetoes that
   candidate's signature until a structurally different one appears.

Everything is counter-driven — no wall clock, no randomness — so a seeded
single-threaded run makes identical sampling, mining, swap and rollback
decisions every time (the drift-replay harness in tests/test_remine.py
asserts exactly that).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set

from .mine import (MinedGraph, ReplayMismatch, UnminableTrace, UnsoundGraph,
                   mine_and_validate, preissue_overlap)


@dataclass
class ReMineConfig:
    """Knobs for the sample → mine → validate → swap → guard loop.

    See docs/TUNING.md ("Sample rate vs re-mine cadence") for how these
    interact with :attr:`repro_torch.core.api.Foreactor.trace_capacity`.
    """

    #: sample 1 in N activations per watched endpoint (serial recording)
    sample_every: int = 8
    #: refuse to mine from fewer than this many resident traces
    min_traces: int = 3
    #: attempt a re-mine every N delivered traces per endpoint
    remine_every: int = 3
    #: newest traces held out of training and scored for predicted
    #: pre-issue improvement (mine_and_validate additionally replays them)
    holdout: int = 1
    #: speculating sessions on the new version before the guard decides
    guard_sessions: int = 6
    #: rollback when new waste rate > baseline * ratio + slack
    guard_waste_ratio: float = 1.5
    guard_waste_slack: float = 0.05
    #: decision-log ring size (the log is the replay-identity artifact)
    max_decisions: int = 256


@dataclass
class _VersionLedger:
    """Waste accounting for all finished sessions of one graph version."""

    sessions: int = 0
    pre_issued: int = 0
    served_async: int = 0
    wasted: int = 0  # cancelled + wasted_completions (the deterministic sum)
    stale_harvests: int = 0

    def add(self, stats) -> None:
        self.sessions += 1
        self.pre_issued += stats.pre_issued
        self.served_async += stats.served_async
        self.wasted += stats.cancelled + stats.wasted_completions
        self.stale_harvests += stats.stale_harvests

    def waste_rate(self) -> float:
        return self.wasted / max(1, self.pre_issued)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "sessions": self.sessions,
            "pre_issued": self.pre_issued,
            "served_async": self.served_async,
            "wasted": self.wasted,
            "stale_harvests": self.stale_harvests,
        }


@dataclass
class _Endpoint:
    """Per-watched-endpoint state, all counter-driven."""

    activations: int = 0
    samples: int = 0
    traces_seen: int = 0
    since_attempt: int = 0
    attempts: int = 0
    swaps: int = 0
    rollbacks: int = 0
    refusals: Dict[str, int] = field(default_factory=dict)
    #: per-graph-version waste ledgers (bounded: old versions evicted)
    ledgers: Dict[int, _VersionLedger] = field(default_factory=dict)
    #: regression-guard state, armed by a swap, cleared by keep/rollback
    guard_version: Optional[int] = None
    guard_sig: Optional[str] = None
    guard_baseline: float = 0.0
    prev_builder: Optional[Callable] = None
    #: signatures of rolled-back candidates — refused until a structurally
    #: different candidate appears (prevents swap/rollback oscillation on
    #: the same bad evidence)
    vetoed: Set[str] = field(default_factory=set)


class ReMiner:
    """Background re-miner: attach to a :class:`repro_torch.core.api.Foreactor`,
    ``watch`` the endpoints whose graphs may drift, and serve traffic.

    "Background" here means *off the request path*, not *on a thread*: the
    attempt runs inline on whichever thread delivered the cadence-tripping
    trace (a sampled request already paying serial cost), which keeps every
    decision deterministic under the drift-replay harness.  All entry
    points (``sample``/``on_trace``/``on_session_finish``) are near-zero
    for unwatched endpoints and one counter bump for watched ones.
    """

    def __init__(self, fa, config: Optional[ReMineConfig] = None,
                 watch: Optional[List[str]] = None):
        self.fa = fa
        self.cfg = config or ReMineConfig()
        self._lock = threading.Lock()
        self._eps: Dict[str, _Endpoint] = {}
        self._decisions: List[Dict[str, Any]] = []
        self._injected = 0
        for name in (watch or []):
            self.watch(name)
        fa.attach_reminer(self)

    # -- wiring -----------------------------------------------------------
    def watch(self, name: str) -> None:
        """Start sampling and re-mining endpoint ``name``."""
        with self._lock:
            self._eps.setdefault(name, _Endpoint())

    def sample(self, name: str) -> bool:
        """Called by ``Foreactor.activate``: elect this activation for
        serial trace recording?  Counter-based (every ``sample_every``-th
        activation) — deterministic, no RNG."""
        with self._lock:
            ep = self._eps.get(name)
            if ep is None:
                return False
            ep.activations += 1
            if ep.activations % self.cfg.sample_every == 0:
                ep.samples += 1
                return True
            return False

    # -- evidence intake --------------------------------------------------
    def on_trace(self, name: str) -> None:
        """A sampled (or explicitly recorded) trace landed in the ring."""
        with self._lock:
            ep = self._eps.get(name)
            if ep is None:
                return
            ep.traces_seen += 1
            ep.since_attempt += 1
            due = ep.since_attempt >= self.cfg.remine_every
            if due:
                ep.since_attempt = 0
        if due:
            self._attempt(name)

    def on_session_finish(self, name: Optional[str], version: int,
                          stats) -> None:
        """Called by ``Foreactor.deactivate`` for every finished
        *speculating* session: feeds the per-version waste ledger and, when
        a guard is armed and has enough evidence, decides keep/rollback."""
        rollback = False
        with self._lock:
            ep = self._eps.get(name) if name else None
            if ep is None:
                return
            led = ep.ledgers.get(version)
            if led is None:
                led = ep.ledgers[version] = _VersionLedger()
                while len(ep.ledgers) > 8:
                    ep.ledgers.pop(min(ep.ledgers))
            led.add(stats)
            if ep.guard_version is not None and version == ep.guard_version \
                    and led.sessions >= self.cfg.guard_sessions:
                rate = led.waste_rate()
                limit = (ep.guard_baseline * self.cfg.guard_waste_ratio
                         + self.cfg.guard_waste_slack)
                if rate > limit:
                    rollback = True
                else:
                    self._decide(name, "keep", "guard_passed",
                                 version=version,
                                 waste_rate=round(rate, 6),
                                 limit=round(limit, 6))
                    ep.guard_version = None
                    ep.guard_sig = None
                    ep.prev_builder = None
        if rollback:
            self._rollback(name)

    # -- the re-mine attempt ----------------------------------------------
    def _attempt(self, name: str) -> None:
        cfg = self.cfg
        pairs = self.fa.traces(name)
        with self._lock:
            self._eps[name].attempts += 1
        if len(pairs) < cfg.min_traces:
            self._refuse(name, "too_few_traces", resident=len(pairs))
            return
        # mine on all resident evidence first (more traces = stronger
        # provenance fitting and more shadow replays).  Right after a drift
        # the ring holds a mix of old- and new-pattern traces, which the
        # full-set attempt correctly refuses — so fall back to the newest
        # ``min_traces`` suffix, the window that converges to pure
        # post-drift evidence fastest.  Both scopes failing is a refusal.
        scopes = [("all", pairs)]
        suffix = pairs[-cfg.min_traces:]
        if len(suffix) < len(pairs):
            scopes.append(("suffix", suffix))
        mined = None
        scope = None
        reason, err = "unminable", ""
        for scope_name, sub in scopes:
            ctxs = [c for (c, _t) in sub]
            trs = [t for (_c, t) in sub]
            try:
                mined = mine_and_validate(trs, ctxs, name=name, holdout=True)
                scope, pairs = scope_name, sub
                break
            except UnminableTrace as e:
                reason, err = "unminable", str(e)[:120]
            except (UnsoundGraph, ReplayMismatch) as e:
                # shadow validation: a trace (possibly the held-out one)
                # the candidate cannot replay byte-for-byte
                reason, err = "shadow", str(e)[:120]
        if mined is None:
            self._refuse(name, reason, error=err)
            return
        sig = mined.signature()
        with self._lock:
            vetoed = sig in self._eps[name].vetoed
        if vetoed:
            self._refuse(name, "vetoed_by_rollback")
            return
        # predicted pre-issue improvement on the held-out (newest) traces
        hold = pairs[-cfg.holdout:]
        try:
            incumbent = self.fa.graph(name)
        except KeyError:
            incumbent = None
        cand_score = sum(
            preissue_overlap(mined.graph, c, t) for (c, t) in hold)
        inc_score = -1 if incumbent is None else sum(
            preissue_overlap(incumbent, c, t) for (c, t) in hold)
        if cand_score <= inc_score:
            self._refuse(name, "no_predicted_improvement",
                         candidate=cand_score, incumbent=inc_score)
            return
        self._swap(name, mined.builder(), sig, scope=scope,
                   candidate=cand_score, incumbent=inc_score)

    def _swap(self, name: str, builder: Callable, sig: str, **detail) -> None:
        with self._lock:
            ep = self._eps[name]
            old_version = self.fa.graph_version(name)
            baseline = ep.ledgers.get(old_version)
            prev = self.fa.swap_graph(name, builder)
            ep.swaps += 1
            # arm the regression guard: the next build is version N+1
            ep.guard_version = old_version + 1
            ep.guard_sig = sig
            ep.guard_baseline = baseline.waste_rate() if baseline else 0.0
            if ep.prev_builder is None:
                ep.prev_builder = prev
            self._decide(name, "swap", "validated_improvement",
                         old_version=old_version,
                         new_version=old_version + 1,
                         baseline_waste=round(ep.guard_baseline, 6),
                         **detail)
        # old-pattern evidence must not seed the next attempt
        self.fa.drop_traces(name)

    def _rollback(self, name: str) -> None:
        with self._lock:
            ep = self._eps[name]
            if ep.guard_version is None or ep.prev_builder is None:
                return
            led = ep.ledgers.get(ep.guard_version)
            self.fa.swap_graph(name, ep.prev_builder, rollback=True)
            ep.rollbacks += 1
            if ep.guard_sig is not None:
                ep.vetoed.add(ep.guard_sig)
            self._decide(name, "rollback", "waste_regression",
                         bad_version=ep.guard_version,
                         waste_rate=round(led.waste_rate(), 6) if led else None,
                         baseline=round(ep.guard_baseline, 6))
            ep.guard_version = None
            ep.guard_sig = None
            ep.prev_builder = None
        self.fa.drop_traces(name)

    # -- canary / observability -------------------------------------------
    def inject_candidate(self, name: str, builder: Callable,
                         sig: Optional[str] = None) -> None:
        """Swap in an externally supplied candidate under the same
        regression guard the miner's own swaps get — the canary API the
        drift-replay harness uses to prove the guard rolls a bad graph
        back.  ``sig`` identifies the candidate in the veto set."""
        self.watch(name)
        with self._lock:
            self._injected += 1
            n = self._injected
        self._swap(name, builder, sig or f"injected#{n}", injected=True)

    def _refuse(self, name: str, reason: str, **detail) -> None:
        with self._lock:
            ep = self._eps[name]
            ep.refusals[reason] = ep.refusals.get(reason, 0) + 1
            self._decide(name, "refuse", reason, **detail)

    def _decide(self, name: str, action: str, reason: str, **detail) -> None:
        # caller may or may not hold the lock; appends are atomic under the
        # GIL and the log is only ever read via snapshot()
        entry = {"endpoint": name, "action": action, "reason": reason}
        if detail:
            entry.update(sorted(detail.items()))
        self._decisions.append(entry)
        del self._decisions[:-self.cfg.max_decisions]

    def decisions(self) -> List[Dict[str, Any]]:
        """The decision log: every refuse/swap/keep/rollback with its why.
        Contains no timestamps or ids — two seeded runs of the same
        workload produce byte-identical logs."""
        return list(self._decisions)

    def snapshot(self) -> Dict[str, Any]:
        """Deterministic full-state dump for reports and replay-identity
        assertions."""
        with self._lock:
            eps = {}
            for name in sorted(self._eps):
                ep = self._eps[name]
                eps[name] = {
                    "activations": ep.activations,
                    "samples": ep.samples,
                    "traces_seen": ep.traces_seen,
                    "attempts": ep.attempts,
                    "swaps": ep.swaps,
                    "rollbacks": ep.rollbacks,
                    "refusals": dict(sorted(ep.refusals.items())),
                    "guard_active": ep.guard_version is not None,
                    "vetoed": len(ep.vetoed),
                    "ledgers": {v: ep.ledgers[v].to_dict()
                                for v in sorted(ep.ledgers)},
                }
            return {"endpoints": eps, "decisions": list(self._decisions)}
