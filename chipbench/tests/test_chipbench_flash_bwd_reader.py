"""The reader of ``flash_bwd_roofline.train`` on a synthetic traced window:
the share of the backward kernels' roofline, computed by hand for
granite's train cell, and no reading where the calls are not two a layer a
traced step."""

from types import SimpleNamespace

import pytest

from chipbench import frozen, spec
from chipbench.trace import Traced

CONFIG = "granite-moe-3b-a800m-l16"
STEPS, LAYERS = 3, 16


def _obs(kernels):
    t = Traced(window_s=3.0, busy_s=2.5, device_ops=len(kernels), top_ops=[], idle_gaps=[],
               kernels=kernels)
    return {"traced": t, "traced_steps": STEPS, "batch": 8, "seq": 1024}


def _ctx():
    return SimpleNamespace(sizes=frozen.Sizes.of(spec.config(CONFIG)["model"]))


def _calls(n, other=()):
    """n backward calls, dQ at 200 µs and dK/dV at 300 µs in turns, among
    ``other`` kernels."""
    out = list(other)
    for i in range(n):
        name = ("(anonymous namespace)::fa_bwd_dq_bf16<64>" if i % 2 == 0 else
                "(anonymous namespace)::fa_bwd_dkdv_bf16<64, 64>")
        out.append((name, 1000.0 * i, 200.0 if i % 2 == 0 else 300.0))
    return out


def test_share_is_the_hand_computed_bound_over_the_kernels_time():
    read = spec.reader("flash_bwd_roofline.train")
    other = [("(anonymous namespace)::fa_fwd_bf16<64, 2, true>", 0.0, 90.0),
             ("void at::native::elementwise_kernel<128, 2>", 5.0, 400.0)]
    # a layer: 10 x 8 x 24 x 524,800 x 64 = 64,487,424,000 FLOP, 65.2047 µs at
    # 989 TFLOP/s, above its 135,790,592 bytes' 40.5345 µs at 3.35 TB/s; 48
    # layers' backwards over 48 x (200 + 300) µs
    got = read(_obs(_calls(2 * LAYERS * STEPS, other)), _ctx())
    assert got == pytest.approx(100 * 48 * 64_487_424_000 / 989e12 / 0.024, rel=1e-12)
    assert got == pytest.approx(13.04094, rel=1e-6)


@pytest.mark.parametrize("n", [0, 2 * LAYERS * STEPS - 1, 2 * LAYERS * STEPS + 2, LAYERS * STEPS])
def test_no_reading_unless_two_calls_a_layer_a_step(n):
    read = spec.reader("flash_bwd_roofline.train")
    assert read(_obs(_calls(n)), _ctx()) is None


def test_no_reading_without_a_traced_window():
    read = spec.reader("flash_bwd_roofline.train")
    assert read({"traced": None, "traced_steps": 0, "batch": 8, "seq": 1024}, _ctx()) is None
