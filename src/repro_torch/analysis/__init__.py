"""Analysis tools of the port: costs counted at the dispatcher
(``cost.py``, in place of the reference's HLO parser), the roofline of one
H100 (``roofline.py``), and the foreaction-graph miner that folds recorded
syscall traces into speculatable graphs (``mine.py``) with its online
re-miner (``remine.py``)."""

from .mine import (MinedGraph, ReplayMismatch, UnminableTrace, UnsoundGraph,
                   mine_and_validate, mine_traces, preissue_overlap,
                   replay_trace, synthesize_trace)
from .remine import ReMineConfig, ReMiner

__all__ = [
    "MinedGraph", "ReplayMismatch", "UnminableTrace", "UnsoundGraph",
    "mine_and_validate", "mine_traces", "replay_trace",
    "preissue_overlap", "synthesize_trace", "ReMineConfig", "ReMiner",
]
