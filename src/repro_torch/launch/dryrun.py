"""Dry-run (PyTorch port): plan every (arch x shape x mesh) cell without
a device; twin of the reference's ``launch/dryrun.py``.

For each cell the dry-run traces the real step (``make_train_step``: loss,
backward and AdamW for train shapes; prefill; one decode step) on ``meta``
tensors under ``analysis.cost.trace_costs`` and records, per device:

* the resident bytes (weights, optimizer state, batch or cache), exact
  from the sharded trees: each leaf's bytes over the product of the mesh
  axes in its spec (``launch/sharding.py``), the reference's formula;
* the temporary peak: the most bytes the trace held at once in tensors
  the step allocated, divided by the mesh's size (the trace runs the whole
  global batch as one device);
* the cost counts (``cost`` and the ``hlo``-keyed block, whose keys are
  the reference's), divided by the mesh's size, ``model_flops`` per
  device, and the roofline of one H100 (``analysis/roofline.py``), with
  no collective term: a single process issues no collectives;
* resident + temporary bytes per device against the card's HBM.

The trace does not depend on the mesh, so each cell is traced once and
planned on every mesh asked for.  The trace follows the plain versions of
the kernels (meta tensors are not CUDA tensors), which hold more memory
than the kernels.

Reports land in ``reports/dryrun_torch/<arch>__<shape>__<mesh>.json``.

Usage::

    python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
    python -m repro_torch.launch.dryrun --all                 # every runnable cell
    python -m repro_torch.launch.dryrun --all --multi-pod     # 2x16x16 pass
    python -m repro_torch.launch.dryrun --all --both-meshes   # both
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Union

import torch

from repro_torch.analysis.cost import CostSummary, trace_costs
from repro_torch.analysis.roofline import HW, model_flops, roofline_from_report
from repro_torch.configs import ARCH_IDS, SHAPES, SKIP_CELLS, ShapeSpec, get_config, resolve
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import abstract, make_production_mesh
from repro_torch.launch.specs import cache_shape, decode_specs, input_specs
from repro_torch.launch.steps import (make_decode_step, make_prefill_step, make_train_step,
                                      train_state_shape)
from repro_torch.models.api import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.tree import tree_leaves


@dataclass
class Cell:
    """One cell: its step's inputs as meta trees and, once traced, the
    step's counts; independent of the mesh."""

    arch: str
    shape: ShapeSpec
    profile: str
    model: Any
    opt_cfg: AdamWConfig
    trees: Dict[str, Any]   # the step's inputs by role: state|params, batch|cache
    cost: Optional[CostSummary] = None
    trace_s: Optional[float] = None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def resident_bytes_per_device(trees: Sequence[Any], spec_trees: Sequence[Any], mesh) -> int:
    """Exact per-device bytes of sharded residents (state/params/cache):
    sum over leaves of nbytes / (product of mesh-axis sizes in its spec)."""
    total = 0
    for tree, specs in zip(trees, spec_trees):
        leaves, spec_leaves = tree_leaves(tree), shd.spec_leaves(specs)
        if len(leaves) != len(spec_leaves):
            raise ValueError(f"{len(leaves)} leaves but {len(spec_leaves)} specs")
        for leaf, spec in zip(leaves, spec_leaves):
            total += _nbytes(leaf) // shd.shard_count(spec, mesh)
    return total


def make_cell(arch: str, shape: Union[str, ShapeSpec], *, smoke: bool = False,
              opt_overrides: Optional[Dict[str, Any]] = None,
              profile: Optional[str] = None) -> Cell:
    """The cell's inputs on the meta device: the train state and batch, the
    params and prompt batch, or the params and serve-time cache."""
    cfg = get_config(arch, smoke=smoke)
    model = build_model(cfg)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    opt_cfg = AdamWConfig(**(opt_overrides or {}))
    if shape.kind == "train":
        trees = {"state": train_state_shape(model, opt_cfg), "batch": input_specs(cfg, shape)}
    else:
        with torch.device("meta"):
            params = model.init(torch.Generator())
        if shape.kind == "prefill":
            trees = {"params": params, "batch": input_specs(cfg, shape)}
        else:
            trees = {"params": params, "cache": cache_shape(model, shape, params)}
    # serve cells engage the model axis ("tp"); train cells use the arch
    # default (fsdp except DeepSeek's EP).
    if profile is None:
        profile = cfg.sharding_profile if shape.kind == "train" else "tp"
    return Cell(resolve(arch), shape, profile, model, opt_cfg, trees)


def trace_cell(cell: Cell) -> Cell:
    """Run the cell's step on its meta inputs under the cost counter."""
    t, model = cell.trees, cell.model
    t0 = time.perf_counter()
    if cell.shape.kind == "train":
        _, cell.cost = trace_costs(make_train_step(model, cell.opt_cfg), t["state"], t["batch"])
    elif cell.shape.kind == "prefill":
        _, cell.cost = trace_costs(make_prefill_step(model, cell.shape.seq_len), t["params"],
                                   t["batch"])
    else:
        _, cell.cost = trace_costs(make_decode_step(model), t["params"], t["cache"],
                                   *decode_specs(model.cfg, cell.shape))
    cell.trace_s = time.perf_counter() - t0
    return cell


def cell_specs(cell: Cell, mesh) -> Dict[str, Any]:
    """The spec tree of each of the cell's input trees on ``mesh``."""
    t = cell.trees
    if "state" in t:
        pspecs = shd.param_specs(t["state"]["params"], mesh)
        return {"state": {"params": pspecs,
                          "opt": shd.opt_state_specs(t["state"]["opt"], pspecs, mesh)},
                "batch": shd.batch_specs(t["batch"], mesh, cell.profile)}
    out = {"params": shd.param_specs(t["params"], mesh)}
    if "batch" in t:
        out["batch"] = shd.batch_specs(t["batch"], mesh, cell.profile)
    else:
        out["cache"] = shd.cache_specs(t["cache"], mesh, cell.profile)
    return out


def resident_on(cell: Cell, mesh) -> int:
    """The cell's resident bytes per device on ``mesh``."""
    specs = cell_specs(cell, mesh)
    return resident_bytes_per_device([cell.trees[k] for k in specs],
                                     [specs[k] for k in specs], mesh)


def mesh_name(mesh) -> str:
    return "x".join(str(n) for n in abstract(mesh).axis_sizes)


def plan(cell: Cell, mesh) -> Dict[str, Any]:
    """The cell's report on ``mesh`` (an ``AbstractMesh`` or a
    ``DeviceMesh``)."""
    mesh = abstract(mesh)
    n = mesh.size
    resident = resident_on(cell, mesh)
    arguments = sum(_nbytes(x) for x in tree_leaves(list(cell.trees.values())))
    dev = cell.cost.per_device(n)
    hw = HW()
    hbm = resident + dev.peak_bytes
    mflops = model_flops(cell.model.cfg, cell.shape, cell.shape.kind) / n
    report = {
        "arch": cell.arch,
        "shape": cell.shape.name,
        "mesh": mesh_name(mesh),
        "profile": cell.profile,
        "devices": n,
        "lower_s": round(cell.trace_s, 2),  # the meta trace
        "compile_s": None,                   # eager torch compiles nothing
        "memory": {
            "argument_bytes": arguments,
            "output_bytes": cell.cost.end_bytes,
            "temp_bytes": cell.cost.peak_bytes,
            "peak_bytes": arguments + cell.cost.peak_bytes,
            "resident_bytes_per_device": resident,
            "temp_bytes_per_device": dev.peak_bytes,
            "hbm_bytes_per_device": hbm,
            "hbm_capacity_bytes": hw.hbm_bytes,
            "hbm_share": hbm / hw.hbm_bytes,
        },
        "cost": {
            "flops": dev.flops,
            "bytes_accessed": dev.bytes_accessed,
            "transcendentals": dev.transcendentals,
        },
        "hlo": dev.to_dict(),
        "model_flops_per_dev": mflops,
    }
    report["roofline"] = roofline_from_report(report, hw, mflops).to_dict()
    return report


def write_report(report: Dict[str, Any], out_dir: str, tag: str = "") -> Dict[str, Any]:
    os.makedirs(out_dir, exist_ok=True)
    path = f"{out_dir}/{report['arch']}__{report['shape']}__{report['mesh']}{tag}.json"
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
    mem, roof = report["memory"], report["roofline"]
    print(f"[dryrun] {report['arch']:22s} {report['shape']:12s} {report['mesh']:8s} "
          f"OK  trace={report['lower_s']:6.1f}s hbm/dev={_gb(mem['hbm_bytes_per_device'])} "
          f"({mem['hbm_share']:.1%} of {_gb(mem['hbm_capacity_bytes'])})  "
          f"dotflops/dev={report['hlo']['dot_flops']:.3e} "
          f"(model {report['model_flops_per_dev']:.3e})  "
          f"bound={roof['bound_s'] * 1e3:.3f}ms ({roof['dominant']})", flush=True)
    return report


def _gb(n) -> str:
    if n is None:
        return "?"
    return f"{n / (1 << 30):.2f}GiB"


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="reports/dryrun_torch")
    ap.add_argument("--no-master", action="store_true",
                    help="memory-lean optimizer (no fp32 master copy)")
    ap.add_argument("--profile", default=None, choices=["tp", "fsdp"],
                    help="override the arch's sharding profile")
    ap.add_argument("--tag", default="", help="report filename suffix")
    args = ap.parse_args(argv)

    opt_overrides = {"keep_master": False} if args.no_master else None
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cells = []
    if args.all:
        for a in ARCH_IDS:
            for s in SHAPES:
                if (a, s) in SKIP_CELLS:
                    print(f"[dryrun] SKIP {a} {s}: {SKIP_CELLS[(a, s)]}")
                    continue
                cells.append((a, s))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells.append((resolve(args.arch), args.shape))

    failures = []
    t_all = time.perf_counter()
    for a, s in cells:
        try:
            cell = trace_cell(make_cell(a, s, opt_overrides=opt_overrides, profile=args.profile))
        except Exception as e:
            failures += [(a, s, mp, repr(e)) for mp in meshes]
            print(f"[dryrun] FAIL {a} {s} (trace): {e}", flush=True)
            traceback.print_exc()
            continue
        for mp in meshes:
            try:
                write_report(plan(cell, make_production_mesh(multi_pod=mp)), args.out, args.tag)
            except Exception as e:
                failures.append((a, s, mp, repr(e)))
                print(f"[dryrun] FAIL {a} {s} multi_pod={mp}: {e}", flush=True)
                traceback.print_exc()
    print(f"[dryrun] {len(cells)} cells traced in {time.perf_counter() - t_all:.1f} s")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        sys.exit(1)
    print("\nall dry-run cells passed")


if __name__ == "__main__":
    main()
