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
