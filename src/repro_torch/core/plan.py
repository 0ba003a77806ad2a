"""Compiled graph plans: lowering a ``ForeactionGraph`` to flat arrays.

The authoring layer (:mod:`repro_torch.core.graph`) optimizes for expressiveness:
nodes are dataclass objects, edges are ``Edge`` records, branch children are
lists, and a peek step chases ``node.out.dst`` attribute chains and hashes
``(name, epochs)`` string-keyed tuples.  That representation is walked on
*every intercepted syscall* (paper §5.2, Algorithm 1), so its interpretation
cost lands directly on the Fig. 10 "pre-issuing algorithm" overhead line —
and it scales with graph-authoring style (a mined 40-node chain pays 40
attribute chases per window walk; a 3-node loop pays 3).

``GraphPlan`` is the same graph lowered once into immutable, topologically
ordered node records held in parallel flat arrays indexed by a dense integer
node id:

* ``kind[i]``          — syscall or branch record
* ``sc[i]``            — syscall id (``Sys``), ``None`` for branch records
* ``effect[i]``        — statically known effect class (paper §3.3), or
                         ``None`` when it depends on runtime args (OPEN's
                         mode flag) — the interpreter then falls back to
                         :func:`repro_torch.core.syscalls.effect_of`
* ``compute[i]`` / ``save[i]`` / ``choose[i]`` — the plugin stub slots
  (argument thunks are *called* at peek time exactly as before; compilation
  never evaluates them)
* ``out_dst[i]`` / ``out_weak[i]`` / ``out_loop[i]`` — a syscall node's one
  outgoing edge (``dst = -1`` encodes End, ``loop = -1`` no epoch bump)
* ``child_off[i]`` + ``edge_dst``/``edge_weak``/``edge_loop`` — a branch
  node's edge table, flattened: child ``k`` of node ``i`` lives at flat
  index ``child_off[i] + k`` (the Choice stub's return value indexes it
  directly, no per-edge object hop)

The interpreter (:meth:`repro_torch.core.engine.SpecSession._peek_and_preissue`)
walks these arrays with integer cursors and a tuple epoch vector; node state
is keyed by ``(node_id, epochs)`` — two machine-word hashes instead of a
string hash per step.

Compilation is cached per ``(graph, depth_mode)``: ``compile_plan`` returns
the *same* ``GraphPlan`` object for repeated calls on one graph (the cache
the ``Foreactor`` relies on so per-activation cost is a dict hit), entries
are evicted when the source graph is garbage collected, and an id-reuse
collision can never alias two distinct graphs (the cache validates through a
weak reference to the source).

Cross-references: docs/ARCHITECTURE.md ("Plan compilation & the unified I/O
plane"); *graph plan* is defined in docs/GLOSSARY.md.
"""

from __future__ import annotations

import threading
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

from .graph import BranchNode, ForeactionGraph, FromNode, SyscallNode
from .syscalls import PURE, Effect, Sys

KIND_SYSCALL = 0
KIND_BRANCH = 1

#: End-of-graph sentinel in dst arrays (no node id is negative)
END = -1


def _static_effect(sc: Sys) -> Optional[Effect]:
    """Effect class when it does not depend on runtime arguments.

    OPEN is the one dynamic case: its mode flag ('r'/'w'/'rw'/'a') decides
    pure vs undoable vs barrier (see ``syscalls.effect_of``)."""
    if sc in PURE:
        return Effect.PURE
    if sc is Sys.OPEN:
        return None
    if sc is Sys.PWRITE:
        return Effect.UNDOABLE
    if sc is Sys.RENAME:
        return Effect.UNDOABLE
    return Effect.BARRIER  # close, fsync, unlink


class GraphPlan:
    """Immutable lowered form of one ``ForeactionGraph``.

    Instances are created by :func:`compile_plan` only; all fields are
    written once during lowering and never mutated afterwards (sessions on
    many threads interpret one plan concurrently)."""

    __slots__ = (
        "name", "num_loops", "num_nodes", "depth_mode",
        "kind", "names", "sc", "effect", "compute", "save", "choose",
        "out_dst", "out_weak", "out_loop",
        "child_off", "edge_dst", "edge_weak", "edge_loop",
        "start_dst", "start_weak", "id_of", "source_ref",
    )

    def __init__(self) -> None:
        self.kind: List[int] = []
        self.names: List[str] = []
        self.sc: List[Optional[Sys]] = []
        self.effect: List[Optional[Effect]] = []
        self.compute: List[Optional[Callable]] = []
        self.save: List[Optional[Callable]] = []
        self.choose: List[Optional[Callable]] = []
        self.out_dst: List[int] = []
        self.out_weak: List[bool] = []
        self.out_loop: List[int] = []
        self.child_off: List[int] = []
        self.edge_dst: List[int] = []
        self.edge_weak: List[bool] = []
        self.edge_loop: List[int] = []
        self.id_of: Dict[str, int] = {}

    # -- derived views -----------------------------------------------------
    @property
    def source(self) -> Optional[ForeactionGraph]:
        """The graph this plan was lowered from (None once collected)."""
        return self.source_ref()

    def initial_epochs(self) -> Tuple[int, ...]:
        return (0,) * self.num_loops

    def structure(self) -> Tuple:
        """Hashable structural fingerprint: everything except the stub
        callables' identities.  Two independent builds of the same authoring
        code lower to equal structures (the plan-equality property test)."""
        return (
            self.name, self.num_loops, tuple(self.kind), tuple(self.names),
            tuple(s.value if s else None for s in self.sc),
            tuple(e.value if e else None for e in self.effect),
            tuple(self.out_dst), tuple(self.out_weak), tuple(self.out_loop),
            tuple(self.child_off), tuple(self.edge_dst),
            tuple(self.edge_weak), tuple(self.edge_loop),
            self.start_dst, self.start_weak,
        )

    # -- symbolic walking (validation replay, tests) -----------------------
    def resolve_branches(self, nid: int, epochs: Tuple[int, ...],
                         ctx: Dict[str, Any],
                         weak: bool) -> Optional[Tuple[int, Tuple[int, ...], bool]]:
        """Follow branch records until a syscall record or End; ``None`` when
        a Choice stub is not ready.  Mirrors the interpreter's inline loop —
        exposed for the validation replay and the lowering-equivalence
        tests."""
        while nid != END and self.kind[nid] == KIND_BRANCH:
            idx = self.choose[nid](ctx, epochs)
            if idx is None:
                return None
            e = self.child_off[nid] + idx
            lid = self.edge_loop[e]
            if lid >= 0:
                epochs = epochs[:lid] + (epochs[lid] + 1,) + epochs[lid + 1:]
            weak = weak or self.edge_weak[e]
            nid = self.edge_dst[e]
        return nid, epochs, weak

    def follow_out(self, nid: int,
                   epochs: Tuple[int, ...]) -> Tuple[int, Tuple[int, ...], bool]:
        """(next id, epochs, edge weak) across a syscall record's out edge."""
        lid = self.out_loop[nid]
        if lid >= 0:
            epochs = epochs[:lid] + (epochs[lid] + 1,) + epochs[lid + 1:]
        return self.out_dst[nid], epochs, self.out_weak[nid]


#: sentinel for "producer result unavailable" during the symbolic walk
_MISSING = object()


def predicted_preissue(plan: GraphPlan, ctx: Dict[str, Any],
                       events) -> int:
    """Predicted pre-issue schedule coverage: how many of ``events`` this
    plan would pre-issue with exactly the application's arguments.

    ``events`` is a sequence of recorded syscalls (``.sc``, ``.args``,
    ``.result`` — :class:`repro_torch.core.trace.TraceEvent` or anything
    shaped like it).  The walk mirrors the validator's serial replay
    (:func:`repro_torch.analysis.mine.replay_trace`) but *scores* instead of
    judging: it stops at the first divergence — wrong syscall kind,
    mismatched arguments, undecidable branch, graph exhausted — and
    returns the count of matched events.  Against a live trace this is the
    number of intercepts the engine's harvest-time argument guard would
    accept from this plan, i.e. the speculation the graph can still buy.

    The online re-miner's improvement check compares this score between
    the incumbent graph and a mined candidate over held-out sampled
    traces: a hot-swap is only allowed when the candidate's predicted
    schedule covers strictly more of the live pattern than the incumbent's
    (a drifted incumbent scores the pre-drift prefix at best)."""
    ctx = dict(ctx)
    ctx.pop("__mined__", None)
    ctx.pop("__mined_n__", None)
    epochs = plan.initial_epochs()
    nid = plan.start_dst
    results: Dict[Tuple[str, Tuple[int, ...]], Any] = {}
    matched = 0
    for ev in events:
        res = plan.resolve_branches(nid, epochs, ctx, False)
        if res is None:
            break
        nid, epochs, _weak = res
        if nid == END or plan.sc[nid] is not ev.sc:
            break
        out = plan.compute[nid](ctx, epochs)
        if out is None:
            break
        args, _link = out
        if len(args) != len(ev.args):
            break
        ok = True
        for a, b in zip(args, ev.args):
            if isinstance(a, FromNode):
                a = results.get((a.name, epochs), _MISSING)
            if a is _MISSING or a != b:
                ok = False
                break
        if not ok:
            break
        results[(plan.names[nid], epochs)] = ev.result
        if plan.save[nid] is not None:
            plan.save[nid](ctx, epochs, ev.result)
        matched += 1
        nid, epochs, _weak = plan.follow_out(nid, epochs)
    return matched


def _topo_order(graph: ForeactionGraph) -> List[str]:
    """Deterministic traversal order from start.  Loop-back edges are
    visited too — usually they only revisit seen nodes, but the validator
    accepts graphs where a node is reachable *only* through one (a
    do-while body), and every reachable node needs an id."""
    order: List[str] = []
    seen = set()
    stack = [graph.start.dst]
    while stack:
        node = stack.pop()
        if node is None or node.name in seen:
            continue
        seen.add(node.name)
        order.append(node.name)
        if isinstance(node, SyscallNode):
            if node.out is not None:
                stack.append(node.out.dst)
        else:
            # reversed: child 0 is visited first, keeping ids aligned with
            # the likely execution order
            for e in reversed(node.children):
                stack.append(e.dst)
    return order


def _lower(graph: ForeactionGraph, depth_mode: str) -> GraphPlan:
    plan = GraphPlan()
    plan.name = graph.name
    plan.num_loops = graph.num_loops
    plan.depth_mode = depth_mode
    order = _topo_order(graph)
    plan.id_of = {name: i for i, name in enumerate(order)}
    plan.num_nodes = len(order)

    def nid(node) -> int:
        return END if node is None else plan.id_of[node.name]

    for name in order:
        node = graph.syscall_nodes.get(name)
        if node is not None:
            plan.kind.append(KIND_SYSCALL)
            plan.names.append(name)
            plan.sc.append(node.sc)
            plan.effect.append(_static_effect(node.sc))
            plan.compute.append(node.compute_args)
            plan.save.append(node.save_result)
            plan.choose.append(None)
            out = node.out
            plan.out_dst.append(nid(out.dst))
            plan.out_weak.append(out.weak)
            plan.out_loop.append(-1 if out.loop_id is None else out.loop_id)
            plan.child_off.append(-1)
        else:
            br: BranchNode = graph.branch_nodes[name]
            plan.kind.append(KIND_BRANCH)
            plan.names.append(name)
            plan.sc.append(None)
            plan.effect.append(None)
            plan.compute.append(None)
            plan.save.append(None)
            plan.choose.append(br.choose)
            plan.out_dst.append(END)
            plan.out_weak.append(False)
            plan.out_loop.append(-1)
            plan.child_off.append(len(plan.edge_dst))
            for e in br.children:
                plan.edge_dst.append(nid(e.dst))
                plan.edge_weak.append(e.weak)
                plan.edge_loop.append(-1 if e.loop_id is None else e.loop_id)
    plan.start_dst = nid(graph.start.dst)
    plan.start_weak = graph.start.weak
    plan.source_ref = weakref.ref(graph)
    return plan


# ---------------------------------------------------------------------------
# The compilation cache: one plan per (graph, depth-mode), for the process
# ---------------------------------------------------------------------------
_cache: Dict[Tuple[int, str], GraphPlan] = {}
_cache_lock = threading.Lock()
#: cache-effectiveness counters (tests + bench_overhead assert on these)
stats = {"compiles": 0, "hits": 0}


def _evict(key: Tuple[int, str]) -> None:
    with _cache_lock:
        _cache.pop(key, None)


def compile_plan(graph: ForeactionGraph,
                 depth_mode: str = "fixed") -> GraphPlan:
    """Lower ``graph`` (or return its cached lowering).

    Repeated calls with the same graph object and depth mode return the
    *identical* ``GraphPlan`` instance — per-activation cost is one dict
    probe.  The entry lives exactly as long as the graph does."""
    key = (id(graph), depth_mode)
    with _cache_lock:
        plan = _cache.get(key)
        if plan is not None and plan.source is graph:
            stats["hits"] += 1
            return plan
    new = _lower(graph, depth_mode)
    with _cache_lock:
        # lost race: someone else compiled while we lowered — keep theirs
        plan = _cache.get(key)
        if plan is not None and plan.source is graph:
            stats["hits"] += 1
            return plan
        stats["compiles"] += 1
        _cache[key] = new
    weakref.finalize(graph, _evict, key)
    return new
