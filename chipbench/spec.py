"""``BENCHMARK.json`` and the files it names: each configuration, traffic
mix, per-layer metric and set of limits is a file of its own, found by its
name, so that a new cell or metric is new files and entries, never an edit.

    chipbench/configs/<config>.json    sizes, source, reduced keys
    chipbench/traffic/<traffic>.json   parameters of one driver kind
    chipbench/limits/<workload>.json   the limit of each number compared
    chipbench/metrics/<metric>.py      read(obs, ctx) -> value or None
"""

from __future__ import annotations

import importlib.util
import json
import re
from functools import lru_cache
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


@lru_cache(maxsize=None)
def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def workload(name: str) -> dict:
    for w in benchmark()["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _json(kind: str, name: str) -> dict:
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    return json.loads((HERE / kind / f"{name}.json").read_text())


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def limits(workload_name: str) -> Dict[str, float]:
    path = HERE / "limits" / f"{workload_name}.json"
    if not path.exists():
        return {}
    return {k: v for k, v in json.loads(path.read_text()).items() if not k.startswith("_")}


def _applies(metric: dict, workload_name: str) -> bool:
    if "workloads" in metric:
        return workload_name in metric["workloads"]
    return True


def end_to_end_for(workload_name: str) -> List[dict]:
    return [m for m in benchmark()["end_to_end"] if _applies(m, workload_name)]


def per_layer_for(workload_name: str) -> List[dict]:
    """The per-layer metrics a cell reports: those listing it, and those
    without a list whose end-to-end metric the cell reports."""
    moves = {m["name"] for m in end_to_end_for(workload_name)}
    return [m for m in benchmark()["per_layer"]
            if (workload_name in m["workloads"] if "workloads" in m else m["moves"] in moves)]


@lru_cache(maxsize=None)
def reader(metric: str) -> Callable:
    """``read(obs, ctx)`` of ``chipbench/metrics/<metric>.py``."""
    if not NAME.match(metric):
        raise ValueError(f"bad metric name {metric!r}")
    path = HERE / "metrics" / f"{metric}.py"
    mod_name = "chipbench.metrics._" + re.sub(r"[^A-Za-z0-9_]", "_", metric)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
