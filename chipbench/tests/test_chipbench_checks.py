"""The comparison that decides ``correct``, driven through whole runs of
each cell's kind at tiny sizes on the CPU: a sound run passes limits set
at twice its own readings, and each fault the cell can have, planted under
the timed path, and the control (the reference in float8 in the program's
place) come out not correct by the same limits."""

import dataclasses

import pytest
import torch

from chipbench import spec
from chipbench.harness import judge, run_cell
from chipbench.tests import tiny

torch.set_num_threads(2)

TRAIN = "granite-moe-3b-a800m-l16.train-b8s1024"
DECODE = tiny.DECODE
PREFILL = "granite-moe-3b-a800m-l16.prefill-b8mix"


def _limits(outcome):
    return {key: 2 * value + 1e-6 for _, value, key in outcome.checks}


@pytest.fixture(scope="module")
def sound():
    runs = {}
    for w in (TRAIN, DECODE, PREFILL):
        outcome, _ = run_cell(tiny.ctx(w, seconds=0.5, control="fp8"))
        runs[w] = outcome
    return runs


@pytest.mark.parametrize("cell", [TRAIN, DECODE, PREFILL])
def test_sound_run_within_limits_at_twice_its_readings(sound, cell):
    ok, report = judge(sound[cell], _limits(sound[cell]))
    assert ok, report
    assert sound[cell].metrics["setup_s"] > 0


@pytest.mark.parametrize("cell,numbers", [
    (TRAIN, ("change_norm_gap", "grad_rel_diff_median")),
    (DECODE, ("mean_gap", "tokens_far_off", "cache_rel_err")),
    (PREFILL, ("mean_gap", "cache_rel_err"))])
def test_control_fails_a_number(sound, cell, numbers):
    limits = _limits(sound[cell])
    readings = sound[cell].control
    assert any(readings["control_" + n] > limits[n] for n in numbers
               if "control_" + n in readings) or any(
        readings[k] > limits[n] for n in numbers for k in readings
        if k.startswith("control_" + n + "."))


def _faulty(cell, limits):
    c = tiny.ctx(cell, seconds=0.5)
    c.limits = limits
    _, result = run_cell(c)
    return result


def test_train_step_returning_its_state_unchanged_is_caught(sound, monkeypatch):
    from repro_torch.launch import steps

    def unchanged(cfg, params, grads, state):
        return params, state, {"grad_norm": torch.zeros(()), "lr": torch.zeros(())}

    monkeypatch.setattr(steps, "adamw_update", unchanged)
    result = _faulty(TRAIN, _limits(sound[TRAIN]))
    assert result["correct"] is False
    assert result["checks"]["change_norm_gap"]["value"] > 0.99


def test_train_step_on_half_the_batch_is_caught(sound, monkeypatch):
    from repro_torch.runtime import trainer
    make = trainer.make_train_step

    def half(model, opt_cfg):
        return make(dataclasses.replace(model, loss=lambda p, b: model.loss(
            p, {k: v[: v.shape[0] // 2] for k, v in b.items()})), opt_cfg)

    monkeypatch.setattr(trainer, "make_train_step", half)
    result = _faulty(TRAIN, _limits(sound[TRAIN]))
    assert result["correct"] is False


def test_train_batch_rows_altered_are_caught(sound, monkeypatch):
    from repro_torch.data import TokenBatchLoader
    load = TokenBatchLoader.load

    def shifted(self, epoch, step):
        return {k: (v + 1) % 500 for k, v in load(self, epoch, step).items()}

    monkeypatch.setattr(TokenBatchLoader, "load", shifted)
    result = _faulty(TRAIN, _limits(sound[TRAIN]))
    assert result["correct"] is False


def _altered_logits(lg):
    lg = lg.clone()
    top = lg[0, :500].argmax()
    lg[0, (top + 1) % 500] = lg[0, top] + 1.0
    return lg


def test_decode_token_altered_where_produced_is_caught(sound, monkeypatch):
    from repro_torch.launch import steps
    make = steps.make_generate_loop

    def served(model, n):
        calls = []

        def decode_step(p, cache, token, pos):
            logits, cache = model.decode_step(p, cache, token, pos)
            calls.append(1)
            return (_altered_logits(logits) if len(calls) % 5 == 0 else logits), cache
        return make(dataclasses.replace(model, decode_step=decode_step), n)

    monkeypatch.setattr(steps, "make_generate_loop", served)
    result = _faulty(DECODE, _limits(sound[DECODE]))
    assert result["correct"] is False
    assert result["checks"]["mean_gap"]["value"] > _limits(sound[DECODE])["mean_gap"]


def test_decode_returned_tokens_altered_are_caught(sound, monkeypatch):
    from repro_torch.launch import steps
    make = steps.make_generate_loop

    def altered(model, n):
        loop = make(model, n)

        def run(*args):
            out = loop(*args).clone()
            if out.shape[1] > 2:  # the measured loops, not the warm-up's
                out[0, 2] = (out[0, 2] + 1) % 500
            return out
        return run

    monkeypatch.setattr(steps, "make_generate_loop", altered)
    result = _faulty(DECODE, _limits(sound[DECODE]))
    assert result["correct"] is False


def test_prefill_first_token_altered_where_produced_is_caught(sound, monkeypatch):
    from repro_torch.launch import steps
    make = steps.make_prefill_step

    def altered(model, max_len):
        step = make(model, max_len)

        def prefill(params, batch):
            logits, cache = step(params, batch)
            return _altered_logits(logits), cache
        return prefill

    monkeypatch.setattr(steps, "make_prefill_step", altered)
    result = _faulty(PREFILL, _limits(sound[PREFILL]))
    assert result["correct"] is False
    assert result["checks"]["mean_gap"]["value"] > _limits(sound[PREFILL])["mean_gap"]


def test_prefill_on_half_the_batch_is_caught(sound, monkeypatch):
    from repro_torch.launch import steps
    make = steps.make_prefill_step

    def half(model, max_len):
        step = make(model, max_len)

        def prefill(params, batch):
            tokens = batch["tokens"]
            logits, cache = step(params, {"tokens": tokens[: tokens.shape[0] // 2]})
            return torch.cat([logits, logits]), [
                {k: torch.cat([v, torch.zeros_like(v)], dim=1) for k, v in run.items()}
                for run in cache]
        return prefill

    monkeypatch.setattr(steps, "make_prefill_step", half)
    result = _faulty(PREFILL, _limits(sound[PREFILL]))
    assert result["correct"] is False


@pytest.mark.parametrize("cell", [TRAIN, DECODE, PREFILL])
def test_traced_run_without_device_events_retries_once_then_falls_back(cell):
    # on the CPU the profiler sees no device event, as it once did on the card
    c = tiny.ctx(cell, seconds=4.0, trace=True)
    outcome, result = run_cell(c)
    obs = outcome.obs
    assert obs["traced"] is None and obs["profiler_retries"] == 1
    assert obs["fallback"].window_s > 0 and obs["fallback"].span_s > 0
    # the metrics the trace does not feed are still read
    mfu = {TRAIN: "mfu.train", DECODE: "mfu.decode", PREFILL: "mfu.prefill"}[cell]
    assert spec.reader(mfu)(obs, c) is not None
    assert cell in tiny.TEST_CELLS or mfu in result["metrics"]
