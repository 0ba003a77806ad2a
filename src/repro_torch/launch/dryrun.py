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
  device, and the roofline of one H100 (``analysis/roofline.py``);
* for train and decode cells (``trace_mesh``), the collectives one device
  issues: the cell's meta trees laid out by ``cell_specs`` as DTensors on
  a ``DeviceMesh`` of the production shape over a fake process
  group of as many ranks, the step traced again under
  ``mesh_context(mesh, cell.profile)``, and the result bytes of each
  collective summed by kind (``analysis.cost.trace_collectives``): the
  ``collective_*`` fields and the roofline's collective term.  A prefill
  cell's stay null with their reason (``PREFILL_REASON``);
* resident + temporary bytes per device against the card's HBM.

The FLOP and byte counts do not depend on the mesh, so each cell is traced
once without one and planned on every mesh asked for; only the
collectives need a trace on each mesh.  The trace follows the plain versions of
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
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.analysis.cost import CostSummary, trace_collectives, trace_costs
from repro_torch.analysis.roofline import HW, model_flops, roofline_from_report
from repro_torch.configs import ARCH_IDS, SHAPES, SKIP_CELLS, ShapeSpec, get_config, resolve
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import abstract, make_production_mesh, mesh_context
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
    #: mesh name -> (result bytes by kind, number of collectives, trace s)
    collectives: Dict[str, Tuple[Dict[str, float], int, float]] = field(default_factory=dict)


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


def fake_mesh(mesh):
    """A CPU ``DeviceMesh`` of ``mesh``'s axes over a fake process group
    of as many ranks, this process rank 0 (any default group is replaced:
    destroy it with ``torch.distributed.destroy_process_group``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    mesh = abstract(mesh)
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=mesh.size)
    return DeviceMesh("cpu", torch.arange(mesh.size).reshape(mesh.axis_sizes),
                      mesh_dim_names=mesh.axis_names)


def _on_mesh(t: torch.Tensor, spec, dmesh):
    """A meta leaf as the DTensor its spec makes of it: rank 0's shard."""
    from torch.distributed.tensor import DTensor

    local = list(t.shape)
    for d, axis in enumerate(spec):
        local[d] //= shd.shard_count((axis,), dmesh)
    return DTensor.from_local(torch.empty(local, dtype=t.dtype, device="meta"), dmesh,
                              shd.placements(spec, dmesh), run_check=False,
                              shape=t.shape, stride=t.stride())


#: the kinds of cell ``main`` traces again over a fake mesh for their collectives
MESH_TRACED = ("train", "decode")
PREFILL_REASON = ("prefill cells are not traced over a mesh: the meshless prefill_32k "
                  "trace already takes minutes on a CPU, and DTensor dispatch is slower "
                  "per op")


def trace_mesh(cell: Cell, mesh) -> Cell:
    """The cell's step over its trees laid out on ``mesh`` (``cell_specs``),
    on a fake process group (``fake_mesh``), under the cell's profile;
    records the collectives one device issues in ``cell.collectives``."""
    from repro_torch.tree import tree_map

    dmesh = fake_mesh(mesh)
    specs = cell_specs(cell, dmesh)
    t = {k: tree_map(lambda x, s: _on_mesh(x, s, dmesh), cell.trees[k], specs[k])
         for k in specs}
    model = cell.model
    t0 = time.perf_counter()
    with mesh_context(dmesh, cell.profile):
        if cell.shape.kind == "train":
            step, args = make_train_step(model, cell.opt_cfg), (t["state"], t["batch"])
        elif cell.shape.kind == "prefill":
            step, args = make_prefill_step(model, cell.shape.seq_len), (t["params"], t["batch"])
        else:
            tok, pos = (_on_mesh(x, shd.spec_from_prefs(x.shape, [(-1, "dp")], dmesh,
                                                        cell.profile), dmesh)
                        for x in decode_specs(model.cfg, cell.shape))
            step, args = make_decode_step(model), (t["params"], t["cache"], tok, pos)
        _, by_kind, count = trace_collectives(step, *args)
    cell.collectives[mesh_name(mesh)] = (by_kind, count, time.perf_counter() - t0)
    return cell


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
    mesh_trace_s = None
    if mesh_name(mesh) in cell.collectives:
        by_kind, count, mesh_trace_s = cell.collectives[mesh_name(mesh)]
        dev = dev.with_collectives(
            by_kind, count, f"one device of {mesh_name(mesh)}, counted over DTensors on a "
            f"fake {n}-rank group")
    elif cell.shape.kind not in MESH_TRACED:
        dev = replace(dev, collective_reason=PREFILL_REASON)
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
        "mesh_trace_s": None if mesh_trace_s is None else round(mesh_trace_s, 2),
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
          f"bound={roof['bound_s'] * 1e3:.3f}ms ({roof['dominant']})"
          + ("" if report["hlo"]["collective_bytes"] is None else
             f"  coll/dev={_gb(report['hlo']['collective_bytes'])} in "
             f"{report['hlo']['collective_count']} (mesh trace={report['mesh_trace_s']:.1f}s)"),
          flush=True)
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
                mesh = make_production_mesh(multi_pod=mp)
                if cell.shape.kind in MESH_TRACED:
                    trace_mesh(cell, mesh)
                write_report(plan(cell, mesh), args.out, args.tag)
            except Exception as e:
                failures.append((a, s, mp, repr(e)))
                print(f"[dryrun] FAIL {a} {s} multi_pod={mp}: {e}", flush=True)
                traceback.print_exc()
    if torch.distributed.is_initialized():  # the fake group of trace_mesh
        torch.distributed.destroy_process_group()
    print(f"[dryrun] {len(cells)} cells traced in {time.perf_counter() - t_all:.1f} s")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        sys.exit(1)
    print("\nall dry-run cells passed")


if __name__ == "__main__":
    main()
