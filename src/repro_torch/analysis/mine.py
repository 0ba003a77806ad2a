"""Foreaction-graph mining from syscall traces — the *speculate* half of
observe-then-speculate.

Hand-writing foreaction graphs is the paper's stated adoption cost.  This
module removes it for the common loop shapes: one or more recorded traces
(:class:`repro_torch.core.trace.Trace`) are folded into a directly-follows graph
and emitted as a ready-to-register ``ForeactionGraph``:

1. **Skeleton folding** — each trace's syscall-kind string is collapsed by
   tandem-repeat detection: a block repeating ``MIN_REPS`` or more times
   becomes a loop segment (emitting an epoch counter), everything else stays
   a literal node.  All traces must align against one skeleton; traces that
   diverge structurally are refused (``UnminableTrace``).
2. **Argument provenance** — for every node and argument position, the
   concrete values across (trace, epoch) samples are explained by a small
   provenance language: invocation input (``ctx[key]``), literal constant,
   affine in the epoch counter, element/attribute of a prior node's result,
   path join of a base and a listing element, clamped residual
   (``min(chunk, total - chunk*ep)``), or the raw buffer of the immediately
   preceding read (→ ``FromNode`` + link flag, the paper's Fig. 4b chain).
   A value no detector can explain is refused.
3. **Loop-count provenance** — iteration counts are explained the same way
   (``len`` of a producer listing, ``len`` of a ctx list, ``ceil(total /
   chunk)``, constant).  Counts that *vary* under a provable upper bound
   become early-exit loops: the body's closing edge is marked *weak*, so the
   engine speculates to the bound but never pre-issues non-pure nodes past
   it (paper §3.3).
4. **Validation** — :func:`replay_trace` replays a trace serially against a
   graph, demanding that every choice is decidable, every argument
   computable and equal to the recorded one, and the end state reachable
   (End, or a weak edge permitting early exit).  :func:`mine_and_validate`
   holds out the last trace and refuses graphs that cannot replay it
   (``UnsoundGraph``) — the soundness gate for ``auto_graph`` wrapping.

``CLOSE``/``FSYNC`` nodes get a *harvest barrier*: their ``ComputeArgs``
only becomes ready once every earlier node has been harvested, so the miner
never schedules an fd teardown concurrently with speculated I/O it cannot
prove independent (the hand-written plugins simply omit those trailing
calls; the mined graphs track them but serve them at the frontier).

Cross-references: docs/AUTHORING.md ("Mining a graph from traces") walks
through this module end-to-end; docs/GLOSSARY.md defines *directly-follows
graph*, *miner*, *validator*, *argument provenance*.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.graph import (BranchNode, Edge, ForeactionGraph, FromNode,
                              GraphBuilder, SyscallNode)
from repro_torch.core.plan import END, compile_plan
from repro_torch.core.syscalls import Sys
from repro_torch.core.trace import Trace, TraceEvent

#: a repeated block must occur at least this many times to fold into a loop
MIN_REPS = 3
#: longest loop body (in syscall nodes) the folder searches for
MAX_PERIOD = 4

#: syscalls that tear down or flush an fd — mined nodes of these kinds get a
#: harvest barrier (never pre-issued ahead of unharvested predecessors)
BARRIER_KINDS = frozenset({Sys.CLOSE, Sys.FSYNC, Sys.UNLINK})


class UnminableTrace(RuntimeError):
    """The trace set cannot be folded into one sound skeleton."""


class ReplayMismatch(RuntimeError):
    """A trace does not replay exactly against a graph."""


class UnsoundGraph(RuntimeError):
    """A mined graph failed held-out replay validation."""


#: sentinel: a provenance whose producer has not been harvested yet
NOT_READY = object()


# ---------------------------------------------------------------------------
# Argument provenance language
# ---------------------------------------------------------------------------
class Prov:
    """Provenance of one argument value: how to recompute it from the
    invocation ctx and prior results, at any epoch."""

    def eval(self, ctx: Dict[str, Any], ep: Tuple[int, ...]) -> Any:
        raise NotImplementedError

    def describe(self) -> str:
        raise NotImplementedError


def _mined(ctx: Dict[str, Any]) -> Dict[str, Any]:
    return ctx.setdefault("__mined__", {})


@dataclass(frozen=True)
class PConst(Prov):
    """A literal recorded in every training trace.  Sound only if the value
    is genuinely invocation-independent — held-out validation is the check."""

    value: Any

    def eval(self, ctx, ep):
        return self.value

    def describe(self):
        v = self.value
        if isinstance(v, bytes) and len(v) > 16:
            return f"literal <{len(v)} bytes>"
        return f"literal {v!r}"


@dataclass(frozen=True)
class PCtx(Prov):
    """An invocation input: ``ctx[key]``."""

    key: str

    def eval(self, ctx, ep):
        return ctx[self.key] if self.key in ctx else NOT_READY

    def describe(self):
        return f"ctx[{self.key!r}]"


@dataclass(frozen=True)
class PLinear(Prov):
    """Affine in one epoch counter: ``a*ep + b`` (offsets, indices)."""

    loop: int
    a: int
    b: int

    def eval(self, ctx, ep):
        return self.a * ep[self.loop] + self.b

    def describe(self):
        return f"{self.a}*ep{self.loop} + {self.b}"


@dataclass(frozen=True)
class PResult(Prov):
    """The harvested result of an epoch-independent node (an fd, a stat)."""

    node: str

    def eval(self, ctx, ep):
        m = _mined(ctx)
        return m[self.node] if self.node in m else NOT_READY

    def describe(self):
        return f"result({self.node!r})"


@dataclass(frozen=True)
class PAttr(Prov):
    """An attribute of a producer's result (``st_size`` of a stat)."""

    node: str
    attr: str

    def eval(self, ctx, ep):
        m = _mined(ctx)
        if self.node not in m:
            return NOT_READY
        return getattr(m[self.node], self.attr)

    def describe(self):
        return f"result({self.node!r}).{self.attr}"


@dataclass(frozen=True)
class PElem(Prov):
    """Element of a producer's list result, indexed by an epoch counter
    (the du shape: ``entries[ep]`` from the getdents listing)."""

    node: str
    loop: int

    def eval(self, ctx, ep):
        m = _mined(ctx)
        if self.node not in m:
            return NOT_READY
        seq = m[self.node]
        i = ep[self.loop]
        return seq[i] if i < len(seq) else NOT_READY

    def describe(self):
        return f"result({self.node!r})[ep{self.loop}]"


@dataclass(frozen=True)
class PCtxElem(Prov):
    """Element of a ctx list, indexed by an epoch counter; ``index`` picks a
    tuple component (``ctx['extents'][ep][2]``)."""

    key: str
    loop: int
    index: Optional[int] = None

    def eval(self, ctx, ep):
        if self.key not in ctx:
            return NOT_READY
        seq = ctx[self.key]
        i = ep[self.loop]
        if i >= len(seq):
            return NOT_READY
        v = seq[i]
        return v if self.index is None else v[self.index]

    def describe(self):
        sub = "" if self.index is None else f"[{self.index}]"
        return f"ctx[{self.key!r}][ep{self.loop}]{sub}"


@dataclass(frozen=True)
class PPathJoin(Prov):
    """``f"{base}/{listing[ep]}"`` — a path built from a directory and one
    of its entries (the du fstat argument)."""

    base: Prov
    node: str
    loop: int

    def eval(self, ctx, ep):
        base = self.base.eval(ctx, ep)
        if base is NOT_READY:
            return NOT_READY
        m = _mined(ctx)
        if self.node not in m:
            return NOT_READY
        seq = m[self.node]
        i = ep[self.loop]
        return f"{base}/{seq[i]}" if i < len(seq) else NOT_READY

    def describe(self):
        return f"{self.base.describe()} + '/' + result({self.node!r})[ep{self.loop}]"


@dataclass(frozen=True)
class PClampedResidual(Prov):
    """``min(chunk, total - chunk*ep)`` — the classic chunked-copy size
    whose final chunk is the remainder."""

    chunk: int
    total: Prov
    loop: int

    def eval(self, ctx, ep):
        total = self.total.eval(ctx, ep)
        if total is NOT_READY:
            return NOT_READY
        return min(self.chunk, total - self.chunk * ep[self.loop])

    def describe(self):
        return f"min({self.chunk}, {self.total.describe()} - {self.chunk}*ep{self.loop})"


@dataclass(frozen=True)
class PLink(Prov):
    """The raw buffer of the immediately preceding read at the same epoch —
    becomes a ``FromNode`` and sets the producer's link flag (Fig. 4b)."""

    node: str

    def eval(self, ctx, ep):
        return FromNode(self.node)

    def describe(self):
        return f"buffer_of({self.node!r})"


# ---------------------------------------------------------------------------
# Loop-count provenance
# ---------------------------------------------------------------------------
class CountProv:
    def value(self, ctx: Dict[str, Any]) -> Any:
        raise NotImplementedError

    def describe(self) -> str:
        raise NotImplementedError


@dataclass(frozen=True)
class CLen(CountProv):
    """``len(result(node))`` — loop over a producer's listing."""

    node: str

    def value(self, ctx):
        m = _mined(ctx)
        return len(m[self.node]) if self.node in m else NOT_READY

    def describe(self):
        return f"len(result({self.node!r}))"


@dataclass(frozen=True)
class CCtxLen(CountProv):
    """``len(ctx[key])`` — loop over an invocation-input list."""

    key: str

    def value(self, ctx):
        return len(ctx[self.key]) if self.key in ctx else NOT_READY

    def describe(self):
        return f"len(ctx[{self.key!r}])"


@dataclass(frozen=True)
class CCeil(CountProv):
    """``ceil(total / chunk)`` — chunked loop over a byte range."""

    total: Prov
    chunk: int

    def value(self, ctx):
        total = self.total.eval(ctx, ())
        if total is NOT_READY:
            return NOT_READY
        return max(0, -(-total // self.chunk))

    def describe(self):
        return f"ceil({self.total.describe()} / {self.chunk})"


@dataclass(frozen=True)
class CConst(CountProv):
    """A constant count recorded in every training trace (trace literal)."""

    n: int

    def value(self, ctx):
        return self.n

    def describe(self):
        return f"literal {self.n}"


# ---------------------------------------------------------------------------
# Skeleton: tandem-repeat folding + alignment
# ---------------------------------------------------------------------------
@dataclass
class LitSeg:
    sc: Sys


@dataclass
class LoopSeg:
    body: List[Sys]
    #: per-trace iteration counts, filled during alignment
    counts: List[int] = field(default_factory=list)


def _fold(kinds: List[Sys]) -> List[Any]:
    """Collapse tandem repeats (period <= MAX_PERIOD, >= MIN_REPS reps)
    into loop segments, left to right, smallest period first."""
    segs: List[Any] = []
    i, n = 0, len(kinds)
    while i < n:
        folded = False
        for p in range(1, MAX_PERIOD + 1):
            if i + p > n:
                break
            r = 1
            while kinds[i + r * p : i + (r + 1) * p] == kinds[i : i + p]:
                r += 1
            if r >= MIN_REPS:
                segs.append(LoopSeg(body=kinds[i : i + p]))
                i += p * r
                folded = True
                break
        if not folded:
            segs.append(LitSeg(sc=kinds[i]))
            i += 1
    return segs


def _align(kinds: List[Sys], segs: List[Any]) -> List[int]:
    """Fit a trace's kind string to a skeleton; returns per-loop counts.
    Raises UnminableTrace on structural divergence."""
    counts: List[int] = []
    i = 0
    for seg in segs:
        if isinstance(seg, LitSeg):
            if i >= len(kinds) or kinds[i] is not seg.sc:
                raise UnminableTrace(
                    f"trace diverges at event {i}: expected {seg.sc}, "
                    f"got {kinds[i] if i < len(kinds) else 'end-of-trace'}"
                )
            i += 1
        else:
            p = len(seg.body)
            c = 0
            while kinds[i : i + p] == seg.body:
                c += 1
                i += p
            counts.append(c)
    if i != len(kinds):
        raise UnminableTrace(
            f"trace has {len(kinds) - i} events beyond the skeleton "
            "(structural divergence the miner cannot fold)"
        )
    return counts


# ---------------------------------------------------------------------------
# Node metadata assembled during mining
# ---------------------------------------------------------------------------
@dataclass
class _NodeInfo:
    name: str
    sc: Sys
    seg_idx: int
    loop: Optional[int]  # loop ordinal, None for literal nodes
    body_pos: int = 0
    #: samples: (trace_idx, epoch_in_loop, event)
    samples: List[Tuple[int, int, TraceEvent]] = field(default_factory=list)
    provs: List[Prov] = field(default_factory=list)
    link: bool = False
    barrier: bool = False


@dataclass
class _LoopInfo:
    ordinal: int
    seg_idx: int
    counts: List[int]
    count_prov: Optional[CountProv] = None
    weak: bool = False
    head: bool = False


@dataclass
class MinedGraph:
    """A mined ``ForeactionGraph`` plus the evidence it was built from."""

    name: str
    graph: ForeactionGraph
    nodes: List[_NodeInfo]
    loops: List[_LoopInfo]
    num_traces: int

    def builder(self):
        """A zero-arg builder suitable for ``Foreactor.register``.  Closes
        over the graph alone — not the MinedGraph, whose evidence samples
        pin every recorded I/O buffer."""
        graph = self.graph
        return lambda: graph

    def signature(self) -> str:
        """Deterministic structural + provenance description; two minings of
        the same trace set must produce identical signatures."""
        lines = [f"mined graph {self.name!r} from {self.num_traces} trace(s)"]
        for nd in self.nodes:
            where = f"loop{nd.loop}[{nd.body_pos}]" if nd.loop is not None else "literal"
            flags = "".join(
                [" link" if nd.link else "", " barrier" if nd.barrier else ""]
            )
            args = ", ".join(p.describe() for p in nd.provs)
            lines.append(f"  {nd.name}: {nd.sc.value} ({where}){flags} <- ({args})")
        for lp in self.loops:
            kind = "early-exit (weak)" if lp.weak else "strong"
            head = " +head" if lp.head else ""
            lines.append(
                f"  loop{lp.ordinal}: count = {lp.count_prov.describe()}, "
                f"{kind}{head}"
            )
        return "\n".join(lines)

    def explain(self) -> str:
        return self.signature()

    def to_dot(self) -> str:
        return self.graph.to_dot()


# ---------------------------------------------------------------------------
# Provenance fitting
# ---------------------------------------------------------------------------
def _all_equal(values: Sequence[Any]) -> bool:
    first = values[0]
    return all(v == first for v in values[1:])


def _fit_per_trace_constant(
    per_trace: Dict[int, Any], ctxs: List[Dict[str, Any]],
    prod_res: Dict[str, Dict[int, Any]], earlier: List[str],
) -> Optional[Prov]:
    """Explain a value that is constant within each trace but may differ
    across traces: ctx input, producer result, or producer attribute."""
    for key in sorted(ctxs[0].keys()):
        if all(key in ctxs[t] and ctxs[t][key] == v for t, v in per_trace.items()):
            return PCtx(key)
    for node in earlier:
        res = prod_res.get(node, {})
        if all(t in res and res[t] == v for t, v in per_trace.items()):
            return PResult(node)
        for attr in ("st_size",):
            try:
                if all(
                    t in res and getattr(res[t], attr) == v
                    for t, v in per_trace.items()
                ):
                    return PAttr(node, attr)
            except AttributeError:
                continue
    vals = list(per_trace.values())
    if _all_equal(vals):
        return PConst(vals[0])
    return None


def _fit_arg(
    node: _NodeInfo,
    pos: int,
    ctxs: List[Dict[str, Any]],
    prod_res: Dict[str, Dict[int, Any]],
    earlier: List[str],
    body_nodes: List[_NodeInfo],
    body_results: Dict[str, Dict[Tuple[int, int], Any]],
) -> Prov:
    """Explain argument ``pos`` of ``node`` across all samples, or raise."""
    samples = [(t, k, ev.args[pos]) for (t, k, ev) in node.samples]
    values = [v for (_t, _k, v) in samples]

    # 1. constant within each trace (covers globally-constant too)
    per_trace: Dict[int, Any] = {}
    per_trace_const = True
    for t, _k, v in samples:
        if t in per_trace:
            if per_trace[t] != v:
                per_trace_const = False
                break
        else:
            per_trace[t] = v
    if per_trace_const:
        prov = _fit_per_trace_constant(per_trace, ctxs, prod_res, earlier)
        if prov is not None:
            return prov
        raise UnminableTrace(
            f"node {node.name!r} arg {pos}: per-invocation value with no "
            f"ctx/producer provenance ({sorted(map(repr, set(map(repr, per_trace.values()))))})"
        )

    # epoch-varying: only meaningful inside a loop
    if node.loop is None:
        raise UnminableTrace(
            f"node {node.name!r} arg {pos}: varying value outside a loop"
        )
    loop = node.loop

    # 2. element of a ctx list (whole element or tuple component) — input-
    # derived provenance is tried before epoch arithmetic: fds and the like
    # often form accidental arithmetic sequences that would misgeneralize
    for key in sorted(ctxs[0].keys()):
        seqs = {t: ctxs[t].get(key) for t in {t for t, _k, _v in samples}}
        if not all(isinstance(s, (list, tuple)) for s in seqs.values()):
            continue
        if all(k < len(seqs[t]) and seqs[t][k] == v for t, k, v in samples):
            return PCtxElem(key, loop)
        elem0 = seqs[next(iter(seqs))]
        width = len(elem0[0]) if elem0 and isinstance(elem0[0], (list, tuple)) else 0
        for j in range(width):
            if all(
                k < len(seqs[t])
                and isinstance(seqs[t][k], (list, tuple))
                and len(seqs[t][k]) > j
                and seqs[t][k][j] == v
                for t, k, v in samples
            ):
                return PCtxElem(key, loop, j)

    # 3. element of a producer's listing result
    for prod in earlier:
        res = prod_res.get(prod, {})
        if not res or not all(isinstance(r, (list, tuple)) for r in res.values()):
            continue
        if all(
            t in res and k < len(res[t]) and res[t][k] == v for t, k, v in samples
        ):
            return PElem(prod, loop)

    # 4. path join: f"{base}/{listing[ep]}"
    if all(isinstance(v, str) for v in values):
        for prod in earlier:
            res = prod_res.get(prod, {})
            if not res or not all(isinstance(r, (list, tuple)) for r in res.values()):
                continue
            bases: Dict[int, str] = {}
            ok = True
            for t, k, v in samples:
                if t not in res or k >= len(res[t]):
                    ok = False
                    break
                tail = f"/{res[t][k]}"
                if not v.endswith(tail):
                    ok = False
                    break
                base = v[: -len(tail)]
                if bases.setdefault(t, base) != base:
                    ok = False
                    break
            if ok:
                base_prov = _fit_per_trace_constant(bases, ctxs, prod_res, earlier)
                if base_prov is not None:
                    return PPathJoin(base_prov, prod, loop)

    # 5. affine in the epoch counter (offsets, indices)
    if all(isinstance(v, int) and not isinstance(v, bool) for v in values):
        by_trace: Dict[int, List[Tuple[int, int]]] = {}
        for t, k, v in samples:
            by_trace.setdefault(t, []).append((k, v))
        fit: Optional[Tuple[int, int]] = None
        for pts in by_trace.values():
            if len(pts) >= 2:
                (k0, v0), (k1, v1) = pts[0], pts[1]
                if k1 != k0 and (v1 - v0) % (k1 - k0) == 0:
                    a = (v1 - v0) // (k1 - k0)
                    fit = (a, v0 - a * k0)
                break
        if fit is not None and all(
            v == fit[0] * k + fit[1] for (_t, k, v) in samples
        ):
            return PLinear(loop, fit[0], fit[1])
        # 6. clamped residual: min(chunk, total - chunk*ep)
        chunk = max(values)
        if chunk > 0:
            totals: Dict[int, int] = {}
            ok = True
            for t, pts in by_trace.items():
                pts = sorted(pts)
                last_k, last_v = pts[-1]
                total = chunk * last_k + last_v
                if not all(v == min(chunk, total - chunk * k) for k, v in pts):
                    ok = False
                    break
                totals[t] = total
            if ok:
                base = _fit_per_trace_constant(totals, ctxs, prod_res, earlier)
                if base is not None:
                    return PClampedResidual(chunk, base, loop)

    # 7. buffer of the immediately preceding read in the same body (link)
    if all(isinstance(v, bytes) for v in values) and node.body_pos > 0:
        prev = body_nodes[node.body_pos - 1]
        if prev.sc is Sys.PREAD:
            res = body_results.get(prev.name, {})
            if all((t, k) in res and res[(t, k)] == v for t, k, v in samples):
                prev.link = True
                return PLink(prev.name)

    raise UnminableTrace(
        f"node {node.name!r} arg {pos}: epoch-varying value with no "
        "provenance (data-dependent argument the miner cannot prove)"
    )


def _fit_count(
    lp: _LoopInfo,
    ctxs: List[Dict[str, Any]],
    prod_res: Dict[str, Dict[int, Any]],
    earlier: List[str],
    chunk_candidates: List[int],
) -> Tuple[CountProv, bool]:
    """Explain a loop's per-trace iteration counts; returns (prov, weak)."""
    counts = lp.counts
    tids = list(range(len(counts)))

    # exact: len of a producer listing
    for node in earlier:
        res = prod_res.get(node, {})
        if res and all(
            t in res
            and isinstance(res[t], (list, tuple))
            and len(res[t]) == counts[t]
            for t in tids
        ):
            return CLen(node), False
    # exact: len of a ctx list
    for key in sorted(ctxs[0].keys()):
        if all(
            key in ctxs[t]
            and isinstance(ctxs[t][key], (list, tuple))
            and len(ctxs[t][key]) == counts[t]
            for t in tids
        ):
            return CCtxLen(key), False
    # exact: ceil(total / chunk)
    for chunk in sorted(set(c for c in chunk_candidates if c > 0)):
        for node in earlier:
            res = prod_res.get(node, {})
            try:
                if res and all(
                    t in res
                    and math.ceil(getattr(res[t], "st_size") / chunk) == counts[t]
                    for t in tids
                ):
                    return CCeil(PAttr(node, "st_size"), chunk), False
            except AttributeError:
                continue
        for key in sorted(ctxs[0].keys()):
            vals = [ctxs[t].get(key) for t in tids]
            if all(isinstance(v, int) and not isinstance(v, bool) for v in vals):
                if all(math.ceil(vals[t] / chunk) == counts[t] for t in tids):
                    return CCeil(PCtx(key), chunk), False
    # exact: constant (trace literal)
    if _all_equal(counts):
        return CConst(counts[0]), False
    # varying under a provable bound: early-exit loop (weak edges)
    for node in earlier:
        res = prod_res.get(node, {})
        if res and all(
            t in res
            and isinstance(res[t], (list, tuple))
            and counts[t] <= len(res[t])
            for t in tids
        ):
            return CLen(node), True
    for key in sorted(ctxs[0].keys()):
        if all(
            key in ctxs[t]
            and isinstance(ctxs[t][key], (list, tuple))
            and counts[t] <= len(ctxs[t][key])
            for t in tids
        ):
            return CCtxLen(key), True
    raise UnminableTrace(
        f"loop {lp.ordinal}: iteration counts {counts} diverge with no "
        "count provenance (data-dependent branch the miner cannot prove)"
    )


# ---------------------------------------------------------------------------
# Stub construction
# ---------------------------------------------------------------------------
def _barrier_requirements(
    nodes: List[_NodeInfo], loops: List[_LoopInfo], upto: int
) -> List[Tuple[str, Any]]:
    """(node name, required harvest count) pairs for every node before index
    ``upto``; loop-body nodes require their loop's dynamic count."""
    reqs: List[Tuple[str, Any]] = []
    for nd in nodes[:upto]:
        if nd.loop is None:
            reqs.append((nd.name, 1))
        else:
            reqs.append((nd.name, loops[nd.loop].count_prov))
    return reqs


def _make_compute_args(
    nd: _NodeInfo, count_prov: Optional[CountProv],
    barrier_reqs: Optional[List[Tuple[str, Any]]],
):
    provs = list(nd.provs)
    link = nd.link
    loop = nd.loop

    def compute_args(ctx, ep):
        if count_prov is not None:
            cnt = count_prov.value(ctx)
            if cnt is NOT_READY or ep[loop] >= cnt:
                return None
        if barrier_reqs is not None:
            harvested = ctx.get("__mined_n__", {})
            for name, need in barrier_reqs:
                if not isinstance(need, int):
                    need = need.value(ctx)
                    if need is NOT_READY:
                        return None
                if harvested.get(name, 0) < need:
                    return None
        out = []
        for p in provs:
            v = p.eval(ctx, ep)
            if v is NOT_READY:
                return None
            out.append(v)
        return tuple(out), link

    return compute_args


def _make_save_result(nd: _NodeInfo):
    name = nd.name
    store = nd.loop is None  # literal results feed downstream provenance

    def save_result(ctx, ep, rc):
        if store:
            _mined(ctx)[name] = rc
        n = ctx.setdefault("__mined_n__", {})
        n[name] = n.get(name, 0) + 1

    return save_result


def _make_head_choice(count_prov: CountProv):
    def choice(ctx, ep):
        cnt = count_prov.value(ctx)
        if cnt is NOT_READY:
            return None
        return 0 if cnt > 0 else 1

    return choice


def _make_more_choice(count_prov: CountProv, loop: int):
    def choice(ctx, ep):
        cnt = count_prov.value(ctx)
        if cnt is NOT_READY:
            return None
        return 0 if ep[loop] + 1 < cnt else 1

    return choice


# ---------------------------------------------------------------------------
# The miner
# ---------------------------------------------------------------------------
def mine_traces(
    traces: Sequence[Trace],
    ctxs: Optional[Sequence[Dict[str, Any]]] = None,
    name: str = "mined",
) -> MinedGraph:
    """Fold one or more traces into a directly-follows graph and emit a
    ``ForeactionGraph``.  Raises :class:`UnminableTrace` when the traces
    diverge structurally or an argument/count has no provenance."""
    if not traces:
        raise UnminableTrace("no traces to mine")
    if ctxs is None:
        ctxs = [{} for _ in traces]
    ctxs = list(ctxs)
    if len(ctxs) != len(traces):
        raise ValueError("ctxs must align 1:1 with traces")
    for t, tr in enumerate(traces):
        for ev in tr:
            if ev.error is not None:
                raise UnminableTrace(
                    f"trace {t} event {ev.seq} recorded an error ({ev.error!r}); "
                    "mine only from clean runs"
                )

    # -- skeleton: try each trace as reference, longest first ---------------
    order = sorted(range(len(traces)), key=lambda t: (-len(traces[t]), t))
    segs = None
    counts_by_trace: List[List[int]] = []
    last_err: Optional[UnminableTrace] = None
    for ref in order:
        cand = _fold(list(traces[ref].kinds()))
        try:
            counts_by_trace = [_align(list(tr.kinds()), cand) for tr in traces]
        except UnminableTrace as e:
            last_err = e
            continue
        segs = cand
        break
    if segs is None:
        raise last_err if last_err is not None else UnminableTrace("empty traces")

    # -- node metadata + sample assignment ----------------------------------
    nodes: List[_NodeInfo] = []
    loops: List[_LoopInfo] = []
    name_counts: Dict[str, int] = {}

    def _node_name(sc: Sys) -> str:
        k = name_counts.get(sc.value, 0) + 1
        name_counts[sc.value] = k
        return sc.value if k == 1 else f"{sc.value}_{k}"

    for si, seg in enumerate(segs):
        if isinstance(seg, LitSeg):
            nodes.append(_NodeInfo(_node_name(seg.sc), seg.sc, si, None))
        else:
            lp = _LoopInfo(ordinal=len(loops), seg_idx=si,
                           counts=[c[len(loops)] for c in counts_by_trace])
            for pos, sc in enumerate(seg.body):
                nodes.append(
                    _NodeInfo(_node_name(sc), sc, si, lp.ordinal, body_pos=pos)
                )
            loops.append(lp)

    node_by_seg: Dict[int, List[_NodeInfo]] = {}
    for nd in nodes:
        node_by_seg.setdefault(nd.seg_idx, []).append(nd)

    body_results: Dict[str, Dict[Tuple[int, int], Any]] = {}
    prod_res: Dict[str, Dict[int, Any]] = {}
    for t, tr in enumerate(traces):
        i = 0
        li = 0
        for si, seg in enumerate(segs):
            if isinstance(seg, LitSeg):
                nd = node_by_seg[si][0]
                nd.samples.append((t, 0, tr[i]))
                prod_res.setdefault(nd.name, {})[t] = tr[i].result
                i += 1
            else:
                cnt = counts_by_trace[t][li]
                li += 1
                for k in range(cnt):
                    for nd in node_by_seg[si]:
                        nd.samples.append((t, k, tr[i]))
                        body_results.setdefault(nd.name, {})[(t, k)] = tr[i].result
                        i += 1

    # -- provenance fitting --------------------------------------------------
    for idx, nd in enumerate(nodes):
        if not nd.samples:
            # a loop no trace entered: keep the node, its args must come from
            # count-bounded provenance — refuse, there is nothing to fit
            raise UnminableTrace(
                f"node {nd.name!r} has no samples (loop never entered)"
            )
        earlier = [p.name for p in nodes[:idx] if p.loop is None]
        body = node_by_seg[nd.seg_idx] if nd.loop is not None else [nd]
        nargs = len(nd.samples[0][2].args)
        if any(len(ev.args) != nargs for (_t, _k, ev) in nd.samples):
            raise UnminableTrace(f"node {nd.name!r}: inconsistent arity")
        nd.provs = [
            _fit_arg(nd, pos, ctxs, prod_res, earlier, body, body_results)
            for pos in range(nargs)
        ]
        nd.barrier = nd.sc in BARRIER_KINDS

    # -- loop-count provenance ----------------------------------------------
    for lp in loops:
        body = node_by_seg[lp.seg_idx]
        chunk_candidates = []
        for nd in body:
            for p in nd.provs:
                if isinstance(p, PLinear) and p.a > 0:
                    chunk_candidates.append(p.a)
                if isinstance(p, PClampedResidual):
                    chunk_candidates.append(p.chunk)
        first_body_idx = nodes.index(body[0])
        earlier = [p.name for p in nodes[:first_body_idx] if p.loop is None]
        lp.count_prov, lp.weak = _fit_count(
            lp, ctxs, prod_res, earlier, chunk_candidates
        )
        # a dynamic count can be zero at a future invocation: guard with a
        # head branch; constant counts observed >= 1 skip it (bptree shape)
        lp.head = not isinstance(lp.count_prov, CConst) or lp.count_prov.n == 0

    # -- graph assembly ------------------------------------------------------
    b = GraphBuilder(name)
    start_name: Optional[str] = None
    #: pending out-edges to wire to the next segment's entry (or End):
    #: ("syscall", src, weak) | ("branch", src)
    pending: List[Tuple[str, str, bool]] = []

    def _wire(dst: Optional[str]) -> None:
        for kind, src, weak in pending:
            if kind == "syscall":
                b.SyscallSetNext(src, dst, weak=weak)
            else:
                b.BranchAppendChild(src, dst)
        pending.clear()

    for si, seg in enumerate(segs):
        segnodes = node_by_seg[si]
        if isinstance(seg, LitSeg):
            nd = segnodes[0]
            barrier_reqs = (
                _barrier_requirements(nodes, loops, nodes.index(nd))
                if nd.barrier
                else None
            )
            b.AddSyscallNode(
                nd.name, nd.sc,
                _make_compute_args(nd, None, barrier_reqs),
                _make_save_result(nd),
            )
            if start_name is None:
                start_name = nd.name
            _wire(nd.name)
            pending.append(("syscall", nd.name, False))
        else:
            lp = next(l for l in loops if l.seg_idx == si)
            entry = None
            if lp.head:
                head = f"loop{lp.ordinal}_head"
                b.AddBranchingNode(head, _make_head_choice(lp.count_prov))
                if start_name is None:
                    start_name = head
                _wire(head)
                entry = head
            for nd in segnodes:
                barrier_reqs = (
                    _barrier_requirements(nodes, loops, nodes.index(nd))
                    if nd.barrier
                    else None
                )
                b.AddSyscallNode(
                    nd.name, nd.sc,
                    _make_compute_args(nd, lp.count_prov, barrier_reqs),
                    _make_save_result(nd),
                )
            first, last = segnodes[0], segnodes[-1]
            if start_name is None:
                start_name = first.name
            if entry is not None:
                b.BranchAppendChild(entry, first.name)
            else:
                _wire(first.name)
            for a, c in zip(segnodes, segnodes[1:]):
                b.SyscallSetNext(a.name, c.name)
            more = f"loop{lp.ordinal}_more"
            b.AddBranchingNode(more, _make_more_choice(lp.count_prov, lp.ordinal))
            b.SyscallSetNext(last.name, more, weak=lp.weak)
            b.BranchAppendChild(more, first.name, loopback=True)
            if entry is not None:
                pending.append(("branch", entry, False))
            pending.append(("branch", more, False))
    _wire(None)
    assert start_name is not None
    b.SetStart(start_name)
    graph = b.Build()
    return MinedGraph(
        name=name, graph=graph, nodes=nodes, loops=loops, num_traces=len(traces)
    )


# ---------------------------------------------------------------------------
# The validator: serial replay
# ---------------------------------------------------------------------------
def replay_trace(graph: ForeactionGraph, ctx: Dict[str, Any], trace: Trace) -> None:
    """Replay ``trace`` serially against ``graph`` with inputs ``ctx``;
    raises :class:`ReplayMismatch` unless every event matches exactly and
    the trace ends at End or across a weak edge.

    The replay walks the graph's *compiled plan* (:mod:`repro_torch.core.plan`) —
    the same lowered representation the engine interprets — so the validator
    proves soundness of exactly the artifact that will speculate, and a
    lowering bug can never pass validation on the object graph while
    misbehaving at run time.  Compilation is cached, so replaying N traces
    lowers the graph once."""
    plan = compile_plan(graph)
    ctx = dict(ctx)
    ctx.pop("__mined__", None)
    ctx.pop("__mined_n__", None)
    epochs = plan.initial_epochs()
    nid = plan.start_dst
    weak_crossed = plan.start_weak
    results: Dict[Tuple[str, Tuple[int, ...]], Any] = {}

    for ev in trace:
        # resolve branch records at the frontier
        res = plan.resolve_branches(nid, epochs, ctx, weak_crossed)
        if res is None:
            raise ReplayMismatch(
                f"event {ev.seq}: branch undecidable at the frontier "
                "(count provenance not ready during serial replay)"
            )
        nid, epochs, weak_crossed = res
        if nid == END:
            raise ReplayMismatch(
                f"event {ev.seq}: graph reached End with {ev.sc} still pending"
            )
        name = plan.names[nid]
        if plan.sc[nid] is not ev.sc:
            raise ReplayMismatch(
                f"event {ev.seq}: graph expects {plan.sc[nid]} at {name!r}, "
                f"trace has {ev.sc}"
            )
        out = plan.compute[nid](ctx, epochs)
        if out is None:
            raise ReplayMismatch(
                f"event {ev.seq}: {name!r} args not computable at the "
                "frontier during serial replay"
            )
        args, _link = out
        if len(args) != len(ev.args):
            raise ReplayMismatch(
                f"event {ev.seq}: {name!r} arity {len(args)} != trace "
                f"arity {len(ev.args)}"
            )
        for i, (a, b2) in enumerate(zip(args, ev.args)):
            if isinstance(a, FromNode):
                a = results.get((a.name, epochs), NOT_READY)
            if a is NOT_READY or a != b2:
                raise ReplayMismatch(
                    f"event {ev.seq}: {name!r} arg {i} computes "
                    f"{a!r}, trace recorded {b2!r}"
                )
        results[(name, epochs)] = ev.result
        if plan.save[nid] is not None:
            plan.save[nid](ctx, epochs, ev.result)
        nid, epochs, weak_crossed = plan.follow_out(nid, epochs)
        # weak resets per step: only the tail matters for the end state
    # trace consumed: must be able to reach End, or have exited over weak
    res = plan.resolve_branches(nid, epochs, ctx, weak_crossed)
    if res is None:
        raise ReplayMismatch(
            "end of trace: branch undecidable, cannot prove completion"
        )
    nid, epochs, weak_crossed = res
    if nid != END and not weak_crossed:
        raise ReplayMismatch(
            f"trace ended at {plan.names[nid]!r} mid-graph with no weak edge "
            "permitting early exit"
        )


def mine_and_validate(
    traces: Sequence[Trace],
    ctxs: Optional[Sequence[Dict[str, Any]]] = None,
    name: str = "mined",
    holdout: bool = True,
) -> MinedGraph:
    """Mine on all-but-the-last trace, then replay *every* trace (including
    the held-out one) against the mined graph.  Raises
    :class:`UnsoundGraph` if any replay fails — the gate that keeps
    ``auto_graph`` wrapping honest."""
    if ctxs is None:
        ctxs = [{} for _ in traces]
    train = traces[:-1] if (holdout and len(traces) >= 2) else traces
    train_ctxs = ctxs[: len(train)]
    mined = mine_traces(train, train_ctxs, name=name)
    for t, (tr, ctx) in enumerate(zip(traces, ctxs)):
        try:
            replay_trace(mined.graph, ctx, tr)
        except ReplayMismatch as e:
            held = " (held-out)" if t >= len(train) else ""
            raise UnsoundGraph(
                f"mined graph {name!r} failed replay of trace {t}{held}: {e}"
            ) from e
    return mined


def preissue_overlap(graph: ForeactionGraph, ctx: Dict[str, Any],
                     trace: Trace) -> int:
    """Predicted pre-issue coverage of ``trace`` by ``graph``'s compiled
    plan — the number of leading events the plan reproduces with exactly
    the recorded arguments (:func:`repro_torch.core.plan.predicted_preissue`).

    This is the re-miner's improvement metric: a full match equals
    ``len(trace)``; a graph that drifted away from the live pattern scores
    only the still-matching prefix."""
    from repro_torch.core.plan import predicted_preissue

    return predicted_preissue(compile_plan(graph), ctx, trace.events)


def synthesize_trace(graph: ForeactionGraph, ctx: Dict[str, Any],
                     device) -> Trace:
    """Execute ``graph``'s compiled plan serially against ``device`` and
    record the resulting syscall trace — the *replay* direction of
    mine∘replay: a graph generating the very traces it was mined from.

    Walks from Start taking strong edges (branch choices must be decidable
    from ``ctx`` plus already-saved results, as in serial replay) and
    executes each computed syscall in order.  Used by the fixed-point
    property test (re-mining a mined graph's own traces must reproduce the
    same pre-issue schedule) and handy for shadow-validating a candidate
    without live traffic.  Raises :class:`ReplayMismatch` when a stub is
    undecidable mid-walk — e.g. a weak loop whose count only a live run
    determines."""
    from repro_torch.core.syscalls import execute

    plan = compile_plan(graph)
    ctx = dict(ctx)
    ctx.pop("__mined__", None)
    ctx.pop("__mined_n__", None)
    out = Trace(graph.name)
    epochs = plan.initial_epochs()
    nid = plan.start_dst
    results: Dict[Tuple[str, Tuple[int, ...]], Any] = {}
    while True:
        res = plan.resolve_branches(nid, epochs, ctx, False)
        if res is None:
            raise ReplayMismatch(
                f"synthesis of {graph.name!r}: branch undecidable at "
                f"event {len(out)} (count provenance needs a live run)")
        nid, epochs, _weak = res
        if nid == END:
            return out
        computed = plan.compute[nid](ctx, epochs)
        if computed is None:
            raise ReplayMismatch(
                f"synthesis of {graph.name!r}: {plan.names[nid]!r} args "
                f"not computable at event {len(out)}")
        args, _link = computed
        resolved = []
        for a in args:
            if isinstance(a, FromNode):
                key = (a.name, epochs)
                if key not in results:
                    raise ReplayMismatch(
                        f"synthesis of {graph.name!r}: link producer "
                        f"{a.name!r} has no result at event {len(out)}")
                a = results[key]
            resolved.append(a)
        resolved = tuple(resolved)
        rc = execute(device, plan.sc[nid], resolved)
        out.append(TraceEvent(seq=len(out), sc=plan.sc[nid],
                              args=resolved, result=rc))
        results[(plan.names[nid], epochs)] = rc
        if plan.save[nid] is not None:
            plan.save[nid](ctx, epochs, rc)
        nid, epochs, _weak = plan.follow_out(nid, epochs)
