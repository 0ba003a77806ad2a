"""Foreactor core: explicit speculation over foreaction graphs.

The paper's contribution (Hu et al., "Foreactor: Exploiting Storage I/O
Parallelism with Explicit Speculation") as a reusable library:

* :mod:`repro_torch.core.graph` — the foreaction graph abstraction (§3.2)
* :mod:`repro_torch.core.plan` — compiled graph plans: the authoring graph
  lowered once to flat node records the engine interprets (§5.2 fast path)
* :mod:`repro_torch.core.engine` — the pre-issuing algorithm (§5.2, Alg. 1)
* :mod:`repro_torch.core.backends` — the unified I/O plane: one reactor with
  pluggable submission lanes (io_uring queue pair, user thread pool,
  per-device lanes, multi-tenant slot scheduling) (§5.4)
* :mod:`repro_torch.core.buffers` — registered buffer pool leased to PREAD
  requests (io_uring READ_FIXED analogue; Fig. 10 "result copy")
* :mod:`repro_torch.core.device` — real / simulated storage devices (§2.1, Fig. 1)
* :mod:`repro_torch.core.api` — plugin registration + interception surface (§5.1)

The sharded multi-device substrate (``ShardedDevice`` + ``MultiQueueBackend``)
extends the paper's single queue pair to one lane per device; see
docs/ARCHITECTURE.md for the full paper-to-module map.
"""

from .api import Foreactor, current_session, io, make_foreactor
from .backends import (
    BACKENDS, IOPlane, MultiQueueBackend, QueuePairBackend, SharedBackend,
    SlotScheduler, SyncBackend, ThreadPoolBackend, make_backend,
)
from .lanes import SubmissionLane
from .buffers import BufferLease, BufferPool
from .completion import CompletionPool, completion_pool
from .device import (
    Device, DeviceProfile, MemDevice, NVME_PROFILE, OSDevice, REMOTE_PROFILE,
    ShardedDevice, SimulatedDevice,
)
from .engine import (DepthController, FuturePoisoned, GraphMismatch,
                     SessionStats, SpecSession)
from .graph import BranchNode, ForeactionGraph, GraphBuilder, SyscallNode
from .plan import GraphPlan, compile_plan
from .syscalls import (Effect, FromRequest, FutureCancelled, IOFuture, Sys,
                       effect_of, is_pure)
from .trace import (RecordingSession, Trace, TraceEvent,
                    TraceRecorder, TraceRing)

__all__ = [
    "Foreactor", "current_session", "io", "make_foreactor",
    "BACKENDS", "IOPlane", "MultiQueueBackend", "QueuePairBackend",
    "SharedBackend", "SlotScheduler", "SubmissionLane", "SyncBackend",
    "ThreadPoolBackend", "make_backend",
    "BufferLease", "BufferPool",
    "CompletionPool", "completion_pool",
    "Device", "DeviceProfile", "MemDevice", "NVME_PROFILE", "OSDevice",
    "REMOTE_PROFILE", "ShardedDevice", "SimulatedDevice",
    "DepthController", "FuturePoisoned", "GraphMismatch", "SessionStats",
    "SpecSession",
    "BranchNode", "ForeactionGraph", "GraphBuilder", "SyscallNode",
    "GraphPlan", "compile_plan",
    "Effect", "FromRequest", "FutureCancelled", "IOFuture", "Sys",
    "effect_of", "is_pure",
    "Trace", "TraceEvent", "TraceRecorder", "TraceRing",
    "RecordingSession",
]
