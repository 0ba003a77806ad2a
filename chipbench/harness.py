"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the per-layer metrics of a traced run.

The drivers (``chipbench/drivers/<kind>.py``, one for each kind of traffic)
do the cell's work and return an :class:`Outcome`; this module builds the
program's model from the configuration's ``model`` block, hands out the
seeded weights, reads the per-layer metrics through their readers and turns
it all into the result line.  Nothing here decides what is fast: the end-to-
end metrics are the drivers' host or device clock readings, the per-layer
ones the readers' (``chipbench/metrics/<name>.py``).
"""

from __future__ import annotations

import gc
import importlib
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Tuple

from chipbench import spec as specs
from chipbench.frozen import Sizes

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"


def program_on_path() -> None:
    """The program under test is ``src/repro_torch`` of the checkout."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))


@dataclass
class Ctx:
    """What a driver is given: the cell, its configuration and traffic, the
    run's arguments, and where it runs."""

    workload: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float
    limits: Dict[str, float] = field(default_factory=dict)
    #: calibration: also read the control, the reference in this precision
    #: ("fp8" or "bf16") in the program's place
    control: str = ""
    #: (what, host clock) as set-up goes, printed to standard error
    marks: List[Tuple[str, float]] = field(default_factory=list)

    def mark(self, what: str) -> None:
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize()
        self.marks.append((what, time.perf_counter()))

    @property
    def sizes(self) -> Sizes:
        return Sizes.of(self.config["model"])

    @property
    def reference(self):
        return importlib.import_module(f"chipbench.reference.{self.config['reference']}")

    def model(self):
        """The program's model, built from the configuration's sizes."""
        program_on_path()
        from repro_torch.models import build_model
        from repro_torch.models.config import MLAConfig, MoEConfig, ModelConfig

        m = dict(self.config["model"])
        m["block_pattern"] = tuple(m.get("block_pattern") or ())
        if m.get("moe") is not None:
            m["moe"] = MoEConfig(**m["moe"])
        if m.get("mla") is not None:
            m["mla"] = MLAConfig(**m["mla"])
        return build_model(ModelConfig(**m))


@dataclass
class Outcome:
    """What a driver returns."""

    metrics: Dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    #: (name, value, limit key): value <= limit is correct
    checks: List[Tuple[str, float, str]]
    #: the per-layer readers' inputs (the traced window and the driver's
    #: own spans and counters)
    obs: Dict[str, Any] = field(default_factory=dict)
    #: readings beside the numbers compared (with a control, its numbers)
    control: Dict[str, float] = field(default_factory=dict)


def free_device_memory(torch) -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def memory_peak(torch, device) -> int:
    if device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


class Stamp:
    """A point on the device's timeline: a CUDA event on the card, the host
    clock elsewhere (CPU tests)."""

    def __init__(self, torch, device):
        if device.type == "cuda":
            self.ev = torch.cuda.Event(enable_timing=True)
            self.ev.record()
            self.t = None
        else:
            self.ev = None
            self.t = time.perf_counter()

    def ms_since(self, other: "Stamp") -> float:
        if self.ev is not None:
            return other.ev.elapsed_time(self.ev)
        return (self.t - other.t) * 1e3


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between order
    statistics (numpy's default)."""
    import numpy as np
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def judge(outcome: Outcome, limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """``correct`` and the numbers compared, each beside its limit.  A
    number without a limit, or one that is not finite, is not correct."""
    report, ok = {}, True
    for name, value, key in outcome.checks:
        limit = limits.get(key)
        report[name] = {"value": value, "limit": limit}
        if limit is None or value is None or not math.isfinite(value) or value > limit:
            ok = False
    return ok, report


def run_cell(ctx: Ctx) -> Tuple[Outcome, dict]:
    """Drive the cell and return its outcome and result line (without the
    device block, which the caller fills)."""
    driver = importlib.import_module(f"chipbench.drivers.{ctx.traffic['kind']}")
    outcome = driver.run(ctx)
    correct, report = judge(outcome, ctx.limits)
    result = {"correct": correct and outcome.failed == 0, "attempted": outcome.attempted,
              "failed": outcome.failed}
    if ctx.trace:
        metrics = {}
        for m in specs.per_layer_for(ctx.workload):
            value = specs.reader(m["name"])(outcome.obs, ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
    else:
        result["metrics"] = {m["name"]: {"value": outcome.metrics[m["name"]], "unit": m["unit"]}
                             for m in specs.end_to_end_for(ctx.workload)
                             if m["name"] in outcome.metrics}
    return outcome, dict(result, checks=report)
