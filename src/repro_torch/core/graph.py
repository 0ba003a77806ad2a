"""The foreaction graph abstraction (paper §3.2).

A foreaction graph is a directed graph describing the exact order of I/O
system calls an application function could issue, plus the computation
needed to produce their argument values:

* **Syscall nodes** — typed (pread/pwrite/...), *pure* iff read-only.
  Annotations map to two plugin stubs (paper §5.1):
  ``ComputeArgs(ctx, epochs) -> None | (args, link)`` (None = not ready) and
  ``SaveResult(ctx, epochs, rc)`` (evaluated exactly once per node x epoch).
* **Branching nodes** — ``Choice(ctx, epochs) -> None | child-index``.
* **Start/End** — implicit: the builder's start edge, and ``Edge(dst=None)``.
* **Edges** — may be *weak* (function may exit early across them) and, for a
  branching node's child, *looping-back* (carries an epoch counter).

Epochs: one counter per looping-back edge; the tuple of all counters
identifies a dynamic node instance, and is passed to every stub so that
array-like variables can be indexed per-iteration.

Cross-references: docs/ARCHITECTURE.md ("Foreaction graphs") maps this module
to paper §3.2; *weak edge*, *epoch vector* and *link flag* are defined in
docs/GLOSSARY.md.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from .syscalls import Effect, Sys, effect_of, is_pure

# Stub signatures (paper §5.1):
#   ComputeArgsFn(ctx, epochs) -> None (not ready) | (args_tuple, link_flag)
#   SaveResultFn(ctx, epochs, rc) -> None
#   ChoiceFn(ctx, epochs) -> None (not ready) | int (child index)
ComputeArgsFn = Callable[[Dict[str, Any], Tuple[int, ...]], Optional[Tuple[Tuple[Any, ...], bool]]]
SaveResultFn = Callable[[Dict[str, Any], Tuple[int, ...], Any], None]
ChoiceFn = Callable[[Dict[str, Any], Tuple[int, ...]], Optional[int]]


class FromNode:
    """Plugin-side deferred argument: 'the result of syscall node ``name``
    at the same epoch'.  The engine rewrites it to a concrete
    :class:`repro_torch.core.syscalls.FromRequest` when pre-issuing; a node whose
    args reference a not-yet-issued producer is simply not ready yet."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __repr__(self) -> str:
        return f"FromNode({self.name!r})"


@dataclass
class Edge:
    dst: Optional["Node"]  # None == the End node
    weak: bool = False
    loop_id: Optional[int] = None  # set iff this is a looping-back edge


class Node:
    name: str


@dataclass
class SyscallNode(Node):
    name: str
    sc: Sys
    compute_args: ComputeArgsFn
    save_result: Optional[SaveResultFn] = None
    out: Optional[Edge] = None

    def pure_with(self, args: Tuple[Any, ...]) -> bool:
        return is_pure(self.sc, args)

    def effect_with(self, args: Tuple[Any, ...]) -> Effect:
        """Three-way effect class of this node with concrete arguments:
        pure / undoable / barrier (the §3.3 pre-issue gate, extended —
        see ``repro_torch.core.syscalls.effect_of``)."""
        return effect_of(self.sc, args)


@dataclass
class BranchNode(Node):
    name: str
    choose: ChoiceFn
    children: List[Edge] = field(default_factory=list)


@dataclass
class ForeactionGraph:
    name: str
    start: Edge
    syscall_nodes: Dict[str, SyscallNode]
    branch_nodes: Dict[str, BranchNode]
    num_loops: int

    def validate(self) -> None:
        """Structural invariants from paper §3.2."""
        for n in self.syscall_nodes.values():
            if n.out is None:
                raise ValueError(f"syscall node {n.name!r} has no outgoing edge")
            if n.out.loop_id is not None:
                raise ValueError(
                    f"loop-back edges may only leave branching nodes, not {n.name!r}"
                )
        for b in self.branch_nodes.values():
            if not b.children:
                raise ValueError(f"branching node {b.name!r} has no outgoing edge")
        seen_loops = set()
        for b in self.branch_nodes.values():
            for e in b.children:
                if e.loop_id is not None:
                    if e.loop_id in seen_loops:
                        raise ValueError("duplicate loop id")
                    seen_loops.add(e.loop_id)
        if len(seen_loops) != self.num_loops:
            raise ValueError("loop count mismatch")
        # reachability: every node reachable from start (ignoring loop edges)
        reach = set()
        stack = [self.start.dst]
        while stack:
            n = stack.pop()
            if n is None or n.name in reach:
                continue
            reach.add(n.name)
            if isinstance(n, SyscallNode):
                stack.append(n.out.dst if n.out else None)
            else:
                stack.extend(e.dst for e in n.children)
        all_names = set(self.syscall_nodes) | set(self.branch_nodes)
        unreachable = all_names - reach
        if unreachable:
            raise ValueError(f"unreachable nodes: {sorted(unreachable)}")

    def initial_epochs(self) -> Tuple[int, ...]:
        return (0,) * self.num_loops

    def to_dot(self) -> str:
        """GraphViz rendering (docs/debugging)."""
        lines = [f'digraph "{self.name}" {{', "  rankdir=LR;", "  S [shape=circle];", "  E [shape=doublecircle];"]

        def ename(e: Edge) -> str:
            return "E" if e.dst is None else f'"{e.dst.name}"'

        def attrs(e: Edge) -> str:
            a = []
            if e.weak:
                a.append("style=dashed")
            if e.loop_id is not None:
                a.append(f'label="loop {e.loop_id}"')
            return f" [{', '.join(a)}]" if a else ""

        lines.append(f"  S -> {ename(self.start)}{attrs(self.start)};")
        for n in self.syscall_nodes.values():
            lines.append(f'  "{n.name}" [shape=box, label="{n.name}\\n{n.sc.value}"];')
            if n.out:
                lines.append(f'  "{n.name}" -> {ename(n.out)}{attrs(n.out)};')
        for b in self.branch_nodes.values():
            lines.append(f'  "{b.name}" [shape=diamond];')
            for e in b.children:
                lines.append(f'  "{b.name}" -> {ename(e)}{attrs(e)};')
        lines.append("}")
        return "\n".join(lines)


class GraphBuilder:
    """Programmatic graph composition — the plugin-code API (paper §5.1).

    Method names mirror libforeactor: ``AddSyscallNode``,
    ``AddBranchingNode``, ``SyscallSetNext``, ``BranchAppendChild``.
    """

    END = None  # sentinel for the End node in SetNext/AppendChild

    def __init__(self, name: str):
        self.name = name
        self._sys: Dict[str, SyscallNode] = {}
        self._br: Dict[str, BranchNode] = {}
        self._start: Optional[str] = None
        self._start_weak = False
        self._loops = 0
        # wiring is recorded by name and resolved at Build() so plugins can
        # forward-reference nodes (loops make that unavoidable).
        self._next: Dict[str, Tuple[Optional[str], bool]] = {}
        self._children: Dict[str, List[Tuple[Optional[str], bool, Optional[int]]]] = {}

    # -- node creation ----------------------------------------------------
    def AddSyscallNode(
        self,
        name: str,
        sc: Sys,
        compute_args: ComputeArgsFn,
        save_result: Optional[SaveResultFn] = None,
    ) -> str:
        if name in self._sys or name in self._br:
            raise ValueError(f"duplicate node name {name!r}")
        self._sys[name] = SyscallNode(name=name, sc=sc, compute_args=compute_args, save_result=save_result)
        if self._start is None:
            self._start = name
        return name

    def AddBranchingNode(self, name: str, choose: ChoiceFn) -> str:
        if name in self._sys or name in self._br:
            raise ValueError(f"duplicate node name {name!r}")
        self._br[name] = BranchNode(name=name, choose=choose)
        if self._start is None:
            self._start = name
        return name

    # -- wiring -----------------------------------------------------------
    def _resolve(self, name: Optional[str]) -> Optional[Node]:
        if name is None:
            return None
        if name in self._sys:
            return self._sys[name]
        if name in self._br:
            return self._br[name]
        raise KeyError(name)

    def SetStart(self, name: str, weak: bool = False) -> None:
        self._start = name
        self._start_weak = weak

    def SyscallSetNext(self, src: str, dst: Optional[str], weak: bool = False) -> None:
        if src not in self._sys:
            raise KeyError(src)
        self._next[src] = (dst, weak)

    def BranchAppendChild(self, src: str, dst: Optional[str], weak: bool = False, loopback: bool = False) -> int:
        if src not in self._br:
            raise KeyError(src)
        loop_id = None
        if loopback:
            loop_id = self._loops
            self._loops += 1
        self._children.setdefault(src, []).append((dst, weak, loop_id))
        return len(self._children[src]) - 1

    def Build(self) -> ForeactionGraph:
        if self._start is None:
            raise ValueError("empty graph")
        for src, (dst, weak) in self._next.items():
            self._sys[src].out = Edge(dst=self._resolve(dst), weak=weak)
        for src, kids in self._children.items():
            self._br[src].children = [
                Edge(dst=self._resolve(dst), weak=weak, loop_id=loop_id)
                for (dst, weak, loop_id) in kids
            ]
        g = ForeactionGraph(
            name=self.name,
            start=Edge(dst=self._resolve(self._start), weak=self._start_weak),
            syscall_nodes=dict(self._sys),
            branch_nodes=dict(self._br),
            num_loops=self._loops,
        )
        g.validate()
        return g
