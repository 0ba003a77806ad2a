"""The reference package and the port side by side, for the twin tests of
the miner, the re-miner, the case-study stores and the I/O server.

``PKGS["jax"]`` and ``PKGS["torch"]`` are namespaces of the same names taken
from ``repro`` and from ``repro_torch``; a twin writes its test body once
against a namespace, runs it on both and compares what comes out.  Objects
of one package never enter the other: enums (``Sys``) and exceptions are
compared by name.
"""

import importlib
from types import SimpleNamespace

ROOTS = {"jax": "repro", "torch": "repro_torch"}

_MINE = ("MinedGraph", "ReplayMismatch", "UnminableTrace", "UnsoundGraph",
         "mine_and_validate", "mine_traces", "preissue_overlap", "replay_trace",
         "synthesize_trace")


def _namespace(root):
    def imp(name):
        return importlib.import_module(f"{root}.{name}")

    core = imp("core")
    ns = SimpleNamespace(**{n: getattr(core, n) for n in core.__all__})
    mine = imp("analysis.mine")
    for n in _MINE:
        setattr(ns, n, getattr(mine, n))
    remine = imp("analysis.remine")
    ns.ReMineConfig, ns.ReMiner = remine.ReMineConfig, remine.ReMiner
    ns.plugins = imp("store.plugins")
    fileutils = imp("store.fileutils")
    ns.cp_file, ns.du_dir = fileutils.cp_file, fileutils.du_dir
    ns.bptree = imp("store.bptree")
    ns.BPTree = ns.bptree.BPTree
    ns.lsm = imp("store.lsm")
    ns.LSMTree = ns.lsm.LSMTree
    recordio = imp("store.recordio")
    ns.RecordShardReader = recordio.RecordShardReader
    ns.RecordShardWriter = recordio.RecordShardWriter
    ns.ioserver = imp("launch.ioserver")
    ns._session_stack = imp("core.api")._session_stack
    syscalls = imp("core.syscalls")
    ns.perform, ns.ReqState = syscalls.perform, syscalls.ReqState
    patterns = imp("core.patterns")
    ns.PATTERNS = patterns.PATTERNS
    ns.build_pread_extents_graph = patterns.build_pread_extents_graph
    plan = imp("core.plan")
    ns.END, ns.KIND_BRANCH, ns.KIND_SYSCALL = plan.END, plan.KIND_BRANCH, plan.KIND_SYSCALL
    ns.root = root
    return ns


PKGS = {name: _namespace(root) for name, root in ROOTS.items()}
J, T = PKGS["jax"], PKGS["torch"]


def both(case, *args, **kwargs):
    """Run ``case(P, ...)`` on the reference and on the port; returns the
    two outputs (reference first)."""
    return case(J, *args, **kwargs), case(T, *args, **kwargs)


def twin(case, *args, **kwargs):
    """Run ``case`` on both packages, assert that the outputs are equal and
    return the port's."""
    ref, port = both(case, *args, **kwargs)
    assert port == ref, (ref, port)
    return port


def plain(v):
    """``v`` with every enum replaced by its value and every exception by
    its class name, so that outputs of the two packages compare."""
    if isinstance(v, (list, tuple)):
        return type(v)(plain(x) for x in v)
    if isinstance(v, dict):
        return {plain(k): plain(x) for k, x in v.items()}
    if isinstance(v, BaseException):
        return type(v).__name__
    if hasattr(v, "value") and type(v).__module__.split(".")[0] in ROOTS.values():
        return v.value
    return v


#: what the port's deepseek-v2-236b ``full()`` adds to the reference
#: package's config: the published YaRN rope, group-limited routing with
#: scaled gates, and the dropless dispatch of the published inference code
PUBLISHED_ONLY = ("rope_type", "yarn_factor", "yarn_original_max_len", "yarn_beta_fast",
                  "yarn_beta_slow", "yarn_mscale", "yarn_mscale_all_dim")
PUBLISHED_ONLY_MOE = ("n_group", "topk_group", "routed_scaling", "norm_topk")


def with_reference_rope_and_routing(cfg):
    """A port config with the reference package's RoPE and routing where it
    states the published ones (deepseek-v2-236b's ``full()``): standard RoPE,
    a plain top-k with renormalised gates and the capacity dispatch, each
    field at its default; any other config as it is.  The twin tests that
    hold a full config against the reference's compare like with like."""
    from dataclasses import fields, replace
    if cfg.rope_type != "yarn":
        return cfg
    default = {f.name: f.default for f in fields(cfg)}
    moe_default = {f.name: f.default for f in fields(cfg.moe)}
    return replace(cfg, **{k: default[k] for k in PUBLISHED_ONLY},
                   moe=replace(cfg.moe, dropless=False,
                               **{k: moe_default[k] for k in PUBLISHED_ONLY_MOE}))
