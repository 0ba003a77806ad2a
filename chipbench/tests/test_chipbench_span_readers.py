"""The readers of the program's spans and counters, on a traced run of the
tiny train cell on the CPU (as the traced-run test of test_chipbench_checks
drives it): each returns a number, the children of each untraced
``train: step`` cover it, ``load_ms.train`` agrees with the benchmark's own
wrapper, and a program without ``repro_torch.spans`` gives no reading."""

import sys

import pytest
import torch

from chipbench import program_spans, spec
from chipbench.harness import run_cell
from chipbench.tests import tiny

torch.set_num_threads(2)

TRAIN = "granite-moe-3b-a800m-l16.train-b8s1024"
READERS = ["load_ms.train", "forward_host_ms.train", "backward_host_ms.train",
           "optimizer_host_ms.train", "sync_wait_ms.train", "device_span_ms.train",
           "moe_dropped_share.train"]


@pytest.fixture(scope="module")
def traced():
    from chipbench.harness import program_on_path
    program_on_path()
    from repro_torch import spans
    spans.reset()
    c = tiny.ctx(TRAIN, seconds=4.0, trace=True)
    outcome, result = run_cell(c)
    return c, outcome, result


@pytest.mark.parametrize("name", READERS)
def test_reader_returns_a_number(traced, name):
    c, outcome, result = traced
    value = spec.reader(name)(outcome.obs, c)
    assert isinstance(value, float) and value >= 0, (name, value)
    assert result["metrics"][name]["value"] == value
    if name == "moe_dropped_share.train":
        assert 0 < value < 100
    elif name != "sync_wait_ms.train":
        assert value > 0


def test_untraced_steps_are_covered_by_their_children(traced):
    """Each untraced step's children cover its span from the step's boundary
    on: before it, inside the step's span, the benchmark's wrapper around
    the loader runs (and stops a traced window)."""
    _, outcome, _ = traced
    steps = program_spans.window_steps(outcome.obs)
    marks = outcome.obs["boundaries"]
    assert len(steps) >= 3 and len(steps) == sum(not m[2] for m in marks[:-1])
    for root, kids, t in steps:
        assert set(kids) == {"data: load", "train: to_device", "train: forward",
                             "train: backward", "train: optimizer", "train: sync"}
        assert root.t0 <= t <= root.t1
        covered = sum(k.t1 - k.t0 for k in kids.values()) / (root.t1 - t)
        assert 0.9 <= covered <= 1.0, covered


def test_load_ms_agrees_with_the_benchmarks_wrapper(traced):
    """On the same steps: the span is the call the wrapper times."""
    c, outcome, result = traced
    marks, waits = outcome.obs["boundaries"], outcome.obs["loader_wait_s"]
    mine = [1e3 * w for m, w in zip(marks, waits) if not m[2]]
    wrapper = sum(mine) / len(mine)
    load = result["metrics"]["load_ms.train"]["value"]
    assert load <= wrapper and wrapper - load <= max(0.1, 0.1 * wrapper), (load, wrapper)


def test_readers_give_nothing_without_the_programs_spans(traced, monkeypatch):
    c, outcome, _ = traced
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert all(spec.reader(name)(outcome.obs, c) is None for name in READERS)
