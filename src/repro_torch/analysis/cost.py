"""Cost of a step counted at the dispatcher (PyTorch port); replaces the
reference's ``src/repro/analysis/hlo.py``, which parses compiled HLO.

The port has no HLO: a step is eager torch.  ``trace_costs(fn, *args)``
runs ``fn`` under a ``TorchDispatchMode`` that sees every aten op the step
dispatches (the backward pass's too) and counts:

* ``dot_flops``: the matrix products (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, and whatever else ``torch.utils.flop_counter``'s registry
  prices), by the registry's formulas, 2 * M * N * K for a product;
  ``dot_bytes``: those ops' operand and result bytes, as ``HloSummary``;
* ``flops``, ``bytes_accessed``, ``transcendentals``: one operation per
  output element of a pointwise op and per input element of a reduction
  on top of ``dot_flops``; the bytes every non-view op reads and writes
  (eager, unfused); the output elements of exponentials, logarithms,
  roots and the sigmoid-like activations;
* the memory of the trace: the most bytes held at once by the tensors the
  step itself allocated (``peak_bytes``: activations, saved tensors,
  gradients, optimizer temporaries, and outputs such as a prefill's cache),
  and those still held when ``fn`` returns (``end_bytes``).  Tensors that
  existed before the call (weights, optimizer state, batch) are not
  counted; writing into them allocates nothing.

Run on ``meta`` tensors, it counts a full-size step and allocates nothing:
the kernels' front door sends non-CUDA tensors to the plain versions
(``kernels/ops.py``), so the counts are those of the plain path.

What the HLO summary's other keys mean here:

* ``while_loops`` is 0 and ``max_trip`` 1: eager Python loops (over
  layers, attention blocks, scan chunks) dispatch every iteration's ops, so
  the counts are already trip-weighted and ``unweighted_dot_flops`` equals
  ``dot_flops``;
* ``collective_bytes``, ``collectives`` and ``collective_count`` are
  ``None`` after ``trace_costs``: a single process issues no collectives
  (``collective_reason``).  ``trace_collectives`` counts them: it runs the
  step over DTensors on a fake many-rank group and sums, per kind, the
  result bytes of each collective one rank issues (the reference sums the
  result shapes of its per-device HLO), and ``with_collectives`` puts them
  in a summary.  On a CPU mesh DTensor moves a shard from one dim to
  another by an all-gather and a chunk (gloo has no all-to-all); the
  trace issues the all-to-all op a CUDA mesh issues instead, so that it
  is counted as one, at its own bytes.

Known difference from the reference's counts: the plain blockwise
attention (``kernels/ref.py:attention_blockwise``) skips key blocks wholly
above the causal diagonal, while the reference's blockwise scan computes
every block and masks it; so wherever S exceeds one query block (512) the
counted causal attention FLOPs are lower than the reference's by design.
"""

from __future__ import annotations

import threading
import weakref
from dataclasses import dataclass, replace
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

COLLECTIVE_REASON = ("single process: no collectives are issued; counting them needs "
                     "the step over DTensors on a fake many-rank group (trace_collectives)")
#: the reference's collective kinds (``analysis/hlo.py``) and the ops of
#: each: the functional collectives DTensor issues, and its all-to-all
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                    "collective-permute")
_KIND_OF = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "permute_tensor": "collective-permute",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "_dtensor")

_aten = torch.ops.aten
_TRANSCENDENTAL = {_aten.exp, _aten.exp2, _aten.expm1, _aten.log, _aten.log1p, _aten.log2,
                   _aten.tanh, _aten.sigmoid, _aten.sin, _aten.cos, _aten.rsqrt,
                   _aten.sqrt, _aten.erf, _aten.silu, _aten.gelu, _aten.softplus}


@dataclass
class CostSummary:
    """Counts of one traced call; ``per_device(n)`` divides them over n
    devices."""

    dot_flops: float = 0.0
    dot_bytes: float = 0.0            # product operand + result traffic
    collective_bytes: Optional[float] = None
    collectives: Optional[Dict[str, float]] = None
    collective_count: Optional[int] = None
    collective_reason: str = COLLECTIVE_REASON
    while_loops: int = 0
    max_trip: int = 1
    flops: float = 0.0
    bytes_accessed: float = 0.0
    transcendentals: float = 0.0
    peak_bytes: int = 0
    end_bytes: int = 0

    @property
    def unweighted_dot_flops(self) -> float:
        return self.dot_flops

    def with_collectives(self, by_kind: Dict[str, float], count: int,
                         reason: str) -> "CostSummary":
        """This summary with the collective counts of one rank (already per
        device: ``per_device`` leaves them)."""
        return replace(self, collectives=dict(by_kind), collective_count=count,
                       collective_bytes=float(sum(by_kind.values())),
                       collective_reason=reason)

    def per_device(self, n: int) -> "CostSummary":
        return replace(self, dot_flops=self.dot_flops / n, dot_bytes=self.dot_bytes / n,
                       flops=self.flops / n, bytes_accessed=self.bytes_accessed / n,
                       transcendentals=self.transcendentals / n,
                       peak_bytes=self.peak_bytes // n, end_bytes=self.end_bytes // n)

    def to_dict(self) -> Dict:
        """The keys of the reference's ``HloSummary.to_dict``, and why the
        collective ones are null."""
        return {
            "dot_flops": self.dot_flops,
            "dot_bytes": self.dot_bytes,
            "collective_bytes": self.collective_bytes,
            "collectives": self.collectives,
            "collective_count": self.collective_count,
            "collective_reason": self.collective_reason,
            "while_loops": self.while_loops,
            "max_trip": self.max_trip,
            "unweighted_dot_flops": self.unweighted_dot_flops,
        }


def _tensors(x: Any):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _CostMode(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.s = CostSummary()
        self.live = 0
        self._held: Dict[int, int] = {}  # storage -> bytes, for storages the trace made
        self._lock = threading.Lock()    # the backward may free on another thread

    def _free(self, key: int) -> None:
        with self._lock:
            self.live -= self._held.pop(key, 0)

    def _hold(self, out, ins) -> None:
        seen = {t.untyped_storage()._cdata for t in ins}
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._held or not st.nbytes():
                continue  # a view of, or a write into, a tensor that exists
            seen.add(key)
            with self._lock:
                self._held[key] = st.nbytes()
                self.live += st.nbytes()
                self.s.peak_bytes = max(self.s.peak_bytes, self.live)
            weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func._overloadpacket not in flop_registry:
            # under inference_mode composite ops (matmul, einsum, linear)
            # arrive whole; count the ops they are made of
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        ins = list(_tensors((args, kwargs)))
        s, packet = self.s, func._overloadpacket
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            b = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in _tensors(out))
            s.dot_flops += f
            s.dot_bytes += b
            s.flops += f
            s.bytes_accessed += b
        elif not func.is_view:
            outs = list(_tensors(out))
            if torch.Tag.pointwise in func.tags:
                s.flops += sum(t.numel() for t in outs)
            elif torch.Tag.reduction in func.tags:
                s.flops += sum(t.numel() for t in ins)
            if packet in _TRANSCENDENTAL:
                s.transcendentals += sum(t.numel() for t in outs)
            s.bytes_accessed += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        self._hold(out, ins)
        return out


class _CollectiveMode(TorchDispatchMode):
    """Counts the collectives one rank issues: a DTensor op is handed back
    to DTensor (``NotImplemented``), whose local ops, collectives included,
    then come through here."""

    def __init__(self):
        super().__init__()
        self.by_kind = {k: 0.0 for k in COLLECTIVE_KINDS}
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(t is DTensor for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if isinstance(func, torch._ops.OpOverload) and func.namespace in _COLLECTIVE_NAMESPACES:
            kind = _KIND_OF.get(func._overloadpacket._qualified_op_name.split("::")[-1])
            if kind is not None:
                self.by_kind[kind] += sum(_nbytes(t) for t in _tensors(out))
                self.count += 1
        return out


def _alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
    """DTensor's shard-to-shard move as the one all-to-all a CUDA mesh
    issues (``_collective_utils.shard_dim_alltoall`` without its CPU
    fallback)."""
    return torch.ops._dtensor.shard_dim_alltoall(input, gather_dim, shard_dim,
                                                 mesh.get_group(mesh_dim).group_name)


def trace_collectives(fn, *args, **kwargs) -> Tuple[Any, Dict[str, float], int]:
    """``fn(*args, **kwargs)`` counting the collectives this rank issues:
    (its result, result bytes by kind, the number of collectives).  For
    traces on ``meta`` tensors over a fake group: the all-to-alls are
    issued as on a CUDA mesh."""
    from torch.distributed.tensor import placement_types

    mode = _CollectiveMode()
    fallback = placement_types.shard_dim_alltoall
    placement_types.shard_dim_alltoall = _alltoall
    try:
        with mode:
            out = fn(*args, **kwargs)
    finally:
        placement_types.shard_dim_alltoall = fallback
    return out, mode.by_kind, mode.count


def trace_costs(fn, *args, **kwargs) -> Tuple[Any, CostSummary]:
    """``fn(*args, **kwargs)`` under the counting mode: (its result, the
    counts).  On meta tensors nothing is allocated."""
    mode = _CostMode()
    with mode:
        out = fn(*args, **kwargs)
    mode.s.end_bytes = mode.live
    return out, mode.s
