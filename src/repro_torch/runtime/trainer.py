"""Fault-tolerant training loop (PyTorch port), twin of the reference
package's ``runtime/trainer.py``.

* deterministic resumability: the data order is a pure function of
  (seed, epoch, step), so restoring {params, opt, epoch, step} from the
  newest committed checkpoint reproduces the exact remaining schedule;
* write-behind checkpointing through the foreactor-backed
  CheckpointManager: the save is one speculated write graph (staged
  creates, pre-issued extent writes, commit marker published last) running
  on a background thread, so checkpoint I/O overlaps step compute and the
  trainer only blocks when a save is still in flight at the next
  checkpoint boundary (``ckpt_wait_s`` in the fit() summary measures
  exactly that residual stall — ``write_behind=False`` degrades to
  synchronous saves for comparison).  The snapshot is a copy into host
  memory the manager owns, enqueued ahead of the next step, because the
  step writes the new state into the old state's buffers;
* straggler watch: a per-step wall-time EMA; steps slower than
  ``straggler_factor x`` EMA are recorded;
* crash safety: any exception triggers a synchronous emergency save of
  the last good state before re-raising.  The port's AdamW writes the new
  values into the state's buffers (the counterpart of the reference's
  donation), so the state is whole only when the exception arrives outside
  ``step_fn``: in batch loading, where ``launch/train.py --kill-at`` and
  the tests raise their simulated node failures, or in the checkpoint
  calls.  An exception from
  inside a step can leave a state that is part old, part new; the
  emergency save then writes that state under the last finished step;
* restore copies into the buffers of a freshly made state, so the state is
  never held twice on the card;
* the loop times itself with ``spans``: each step is a ``train: step`` span
  around ``data: load``, ``train: to_device``, the step function's three
  phases and ``train: sync`` (the host waiting for the step's device work);
  the checkpoint calls are ``checkpoint: save`` / ``wait`` / ``restore``
  spans, whose host times add up to ``ckpt_wait_s`` and ``restore_s``; the
  fit() summary's ``phase_ms`` holds each phase's median.

The trainer runs over a ``DeviceMesh`` (the reference's ``mesh``
argument) or, given a device or None, on one device without a mesh.  Over a
mesh ``fit`` runs under ``mesh_context`` with the caller's sharding profile
(``set_sharding_profile``; "tp" unless the caller sets another, as in the
reference, whose launcher sets none); the state
is replicated over the mesh, as the reference's jit without
``in_shardings`` keeps it; each rank loads the same global batch (the
loader is a pure function of (seed, epoch, step)) and keeps its rows over
the data axes; the activation constraints place the rest.  Checkpoints are
mesh-agnostic (full arrays, named leaves: rank 0 writes them), so ``fit``
resumes on a mesh of another shape, or without one.  The step is eager
PyTorch (``make_train_step``), where the reference jits and donates.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager, CheckpointPolicy
from repro_torch.data.pipeline import TokenBatchLoader
from repro_torch.launch.mesh import mesh_context, replicate, shard_batch
from repro_torch.launch.steps import make_train_state, make_train_step
from repro_torch.models.api import Model
from repro_torch.models.common import get_sharding_profile, is_dtensor
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.spans import records, span
from repro_torch.tree import tree_map


@dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 50
    log_every: int = 10
    seed: int = 0
    straggler_factor: float = 3.0
    restore: bool = True
    #: overlap checkpoint saves with step compute (save_async); False runs
    #: every save synchronously on the training thread
    write_behind: bool = True
    #: retention policy installed on the CheckpointManager at fit() time
    #: (None keeps whatever the manager was built with); every save is
    #: followed by a GC pass collecting steps outside the policy's keep-set
    retention: Optional[CheckpointPolicy] = None
    #: delta cadence: number of delta (incremental) saves between full
    #: saves.  0 = every save full; k writes k deltas then one full, so a
    #: restore chains at most k+1 checkpoints.
    delta_every: int = 0


@dataclass
class StepEvent:
    step: int
    seconds: float
    loss: float
    straggler: bool
    #: a write-behind save was still running when the step ended
    save_in_flight: bool = False


class Trainer:
    def __init__(self, model: Model, opt_cfg: AdamWConfig,
                 loader: TokenBatchLoader, ckpt: Optional[CheckpointManager],
                 mesh: Any, tcfg: TrainerConfig = TrainerConfig(),
                 batch_extras: Optional[Callable[[Dict], Dict]] = None):
        """``mesh``: a ``DeviceMesh``, or a device (or None: the CPU) to
        train on without a mesh."""
        from torch.distributed.device_mesh import DeviceMesh

        self.model = model
        self.opt_cfg = opt_cfg
        self.loader = loader
        self.ckpt = ckpt
        self.mesh = mesh if isinstance(mesh, DeviceMesh) else None
        if self.mesh is None:
            self.device = torch.device("cpu" if mesh is None else mesh)
        elif self.mesh.device_type == "cuda":
            self.device = torch.device("cuda", torch.cuda.current_device())
        else:
            self.device = torch.device(self.mesh.device_type)
        self.tcfg = tcfg
        self.batch_extras = batch_extras
        self.events: List[StepEvent] = []
        self.stragglers: List[int] = []
        self.ckpt_wait_s = 0.0  # training-thread time lost to checkpoint I/O
        self.ckpt_saves = 0
        #: seconds of the restore in fit() (0.0 when nothing was restored)
        self.restore_s = 0.0
        # delta cadence state: primed so the very first save is a full one
        self._saves_since_full = tcfg.delta_every

    def _next_delta(self) -> bool:
        """True iff the next periodic save should be incremental: the
        cadence writes ``delta_every`` deltas between full saves (the
        emergency save is always full — the crash path should not depend
        on chain state)."""
        if self.tcfg.delta_every <= 0:
            return False
        if self._saves_since_full >= self.tcfg.delta_every:
            self._saves_since_full = 0
            return False
        self._saves_since_full += 1
        return True

    # -- state and batches -------------------------------------------------
    def _init_or_restore(self):
        start_epoch, start_step = 0, 0
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        state = make_train_state(self.model, self.opt_cfg, gen)
        if self.mesh is not None:
            state = replicate(state, self.mesh)
        if self.ckpt is not None and self.tcfg.restore:
            with span("checkpoint: restore") as restoring:
                out = self.ckpt.restore_latest(like=state)
                if out is not None:
                    ckpt_step, tree, extra = out
                    # every rank reads the whole tree into its replica
                    tree_map(lambda dst, src: (dst.to_local() if is_dtensor(dst) else dst)
                             .copy_(src), state, tree)
                    del tree
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
            if out is not None:
                self.restore_s = restoring.seconds
                start_epoch = int(extra.get("epoch", 0))
                start_step = int(extra.get("step", ckpt_step))
                print(f"[trainer] restored step {ckpt_step} "
                      f"-> resuming at (epoch {start_epoch}, step {start_step})")
        return state, start_epoch, start_step

    def _to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Host arrays -> tensors on the device: pinned and non-blocking on
        the card."""
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    # -- the loop ------------------------------------------------------------
    def fit(self) -> Dict[str, Any]:
        if self.mesh is None:
            return self._fit()
        with mesh_context(self.mesh, get_sharding_profile()):
            return self._fit()

    def _fit(self) -> Dict[str, Any]:
        if self.ckpt is not None and self.tcfg.retention is not None:
            self.ckpt.policy = self.tcfg.retention
        step_fn = make_train_step(self.model, self.opt_cfg)
        state, epoch, step0 = self._init_or_restore()
        spe = self.loader.steps_per_epoch
        ema = None
        losses = []
        global_step = step0
        first = None  # the id of the first step's span
        try:
            while global_step < self.tcfg.steps:
                e, s = divmod(global_step, spe)
                with span("train: step", step=global_step) as root:
                    first = root.id if first is None else first
                    batch = self.loader.load(e, s)
                    if self.batch_extras is not None:
                        batch = self.batch_extras(batch)
                    with span("train: to_device") as moved:
                        batch = self._to_device(batch)
                        if self.mesh is not None:
                            batch = shard_batch(batch, self.mesh)
                    state, metrics = step_fn(state, batch)
                    with span("train: sync") as synced:
                        metrics = {k: v.full_tensor() if is_dtensor(v) else v
                                   for k, v in metrics.items()}
                        loss = float(metrics["loss"])
                dt = (synced.t1 - moved.t1) / 1e9  # the step and its sync
                in_flight = self.ckpt is not None and self.ckpt.save_in_flight()
                straggler = ema is not None and dt > self.tcfg.straggler_factor * ema
                ema = dt if ema is None else 0.9 * ema + 0.1 * dt
                self.events.append(StepEvent(global_step, dt, loss, straggler, in_flight))
                if straggler:
                    self.stragglers.append(global_step)
                    print(f"[trainer] STRAGGLER step {global_step}: "
                          f"{dt:.3f}s vs ema {ema:.3f}s")
                losses.append(loss)
                if self.tcfg.log_every and global_step % self.tcfg.log_every == 0:
                    print(f"[trainer] step {global_step:5d} loss {loss:.4f} "
                          f"gnorm {float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms")
                global_step += 1
                if self.ckpt is not None and self.tcfg.ckpt_every \
                        and global_step % self.tcfg.ckpt_every == 0:
                    e2, s2 = divmod(global_step, spe)
                    extra = {"epoch": e2, "step": global_step}
                    delta = self._next_delta()
                    with span("checkpoint: save", step=global_step, delta=delta) as saving:
                        if self.tcfg.write_behind:
                            # blocks only while a previous save is still in
                            # flight; the write graph runs behind compute
                            self.ckpt.save_async(global_step, state,
                                                 extra=extra, delta=delta)
                        else:
                            self.ckpt.save(global_step, state, extra=extra,
                                           delta=delta)
                    self.ckpt_wait_s += saving.seconds
                    self.ckpt_saves += 1
        except BaseException:
            if self.ckpt is not None:
                try:  # emergency checkpoint of the last good state
                    with span("checkpoint: wait"):
                        self.ckpt.wait_pending()
                    with span("checkpoint: save", step=global_step, emergency=True):
                        self.ckpt.save(global_step, state,
                                       extra={"epoch": epoch, "step": global_step,
                                              "emergency": True})
                    print(f"[trainer] emergency checkpoint at step {global_step}")
                except BaseException as e2:
                    print(f"[trainer] emergency save failed: {e2!r}")
            raise
        if self.ckpt is not None:
            with span("checkpoint: wait") as waiting:
                self.ckpt.wait_pending()
            delta = self._next_delta()
            with span("checkpoint: save", step=global_step, delta=delta) as saving:
                self.ckpt.save(global_step, state,
                               extra={"epoch": epoch, "step": global_step}, delta=delta)
            self.ckpt_wait_s += waiting.seconds + saving.seconds
            self.ckpt_saves += 1
        return {
            "state": state,
            "losses": losses,
            "final_step": global_step,
            "stragglers": self.stragglers,
            "ckpt_wait_s": self.ckpt_wait_s,
            "ckpt_saves": self.ckpt_saves,
            "mean_step_s": float(np.mean([ev.seconds for ev in self.events[1:]]))
            if len(self.events) > 1 else None,
            "phase_ms": phase_ms(first),
        }


def phase_ms(first: Optional[int]) -> Dict[str, Dict[str, float]]:
    """The median host ms of each ``train:`` and ``data:`` span of the steps
    from the step span ``first`` on (those the spans' ring still holds),
    and its median device ms where the device's clock timed it."""
    if first is None:
        return {}
    host: Dict[str, List[float]] = {}
    device: Dict[str, List[float]] = {}
    for sp in records():
        if sp.root >= first and sp.name.startswith(("train:", "data:")):
            host.setdefault(sp.name, []).append(sp.host_ms)
            ms = sp.device_ms
            if ms is not None:
                device.setdefault(sp.name, []).append(ms)
    out = {}
    for name, values in host.items():
        out[name] = {"host": float(np.median(values))}
        if name in device:
            out[name]["device"] = float(np.median(device[name]))
    return out
