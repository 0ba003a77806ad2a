"""Port scan kernels vs the JAX reference on the same inputs.

On the CPU the port's scan wrappers run their plain versions (the chunked
references); they are held against the JAX Pallas kernels in interpret
mode (the kernel bodies executing on the CPU) and against the JAX token
recurrences, at the shapes and tolerances of tests/test_kernels.py.  The
decode steps are held against the JAX steps, and against the port's own
scans.  The CUDA kernels themselves are held against the plain versions on
the card by chip_smoke.py and by tests/test_torch_cuda.py.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.mamba2_scan import mamba2_scan as j_mamba2_scan
from repro.kernels.rwkv6_scan import rwkv6_scan as j_rwkv6_scan
from repro_torch.bridge import params_from_numpy
from repro_torch.kernels import mamba2_scan as m2
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rwkv6_scan as r6

# the test workers share the machine's cores: two intra-op threads each keep
# torch from starving the others (tests/test_system.py times wall clocks)
torch.set_num_threads(2)


def both(x):
    """The same values as a JAX array and as a CPU tensor (bit-identical,
    bf16 included)."""
    return x, params_from_numpy(np.asarray(x), "cpu")


def normal(rng, shape, dtype=jnp.float32):
    return both(jnp.asarray(rng.normal(size=shape).astype(np.float32), dtype))


def uniform(rng, lo, hi, shape):
    return both(jnp.asarray(rng.uniform(lo, hi, shape).astype(np.float32)))


def close(got: torch.Tensor, want, tol):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    # `pytest -s` shows these lines: the CPU parity table of PERF.md
    print(f"[parity] {os.environ.get('PYTEST_CURRENT_TEST', '').split(' ')[0]}: "
          f"max_abs_err={np.abs(got - want).max():.3e} tol={tol:g}")
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


@pytest.fixture(autouse=True)
def no_launches():
    """CPU tensors never reach a kernel: the counters stay at 0."""
    ops.reset_launch_counts()
    yield
    assert ops.launch_counts() == {"flash_attention_fwd": 0, "flash_decode": 0,
                                   "mamba2_scan": 0, "rwkv6_scan": 0}


def mamba2_inputs(rng, B, S, H, P, G, N, dtype=jnp.float32, h0=True):
    """The distributions of tests/test_kernels.py."""
    x = normal(rng, (B, S, H, P), dtype)
    dt = uniform(rng, 0.01, 0.2, (B, S, H))
    A = both(jnp.asarray(-rng.uniform(0.5, 2, H).astype(np.float32)))
    Bm, Cm = normal(rng, (B, S, G, N), dtype), normal(rng, (B, S, G, N), dtype)
    h = normal(rng, (B, H, P, N)) if h0 else (None, None)
    return tuple(zip(x, dt, A, Bm, Cm, h))  # (jax args, torch args)


def rwkv6_inputs(rng, B, S, H, K, V, dtype=jnp.float32, w_max=3.0, grid=True):
    """The distributions of tests/test_kernels.py.  With ``grid``, w lies on
    a 2^-6 grid, so every prefix sum of w is exact in fp32 whatever the
    summation order.  Off the grid, fp32 prefix sums near -190 round by
    ~1e-5 and the decay exp(cwx_t - cw_s) of two summation orders differs
    by more than 5e-5 relative: the reference's 5e-5 holds between its
    chunked form and its kernel because both take jnp.cumsum, not between
    two packages whose cumsums add in different orders."""
    r, k, v = normal(rng, (B, S, H, K), dtype), normal(rng, (B, S, H, K), dtype), \
        normal(rng, (B, S, H, V), dtype)
    w = -rng.uniform(0.01, w_max, (B, S, H, K))
    if grid:
        w = -np.maximum(np.round(-w * 64), 1) / 64
    w = both(jnp.asarray(w.astype(np.float32)))
    u, s0 = normal(rng, (H, K)), normal(rng, (B, H, K, V))
    return tuple(zip(r, k, v, w, u, s0))


# -- mamba2 -------------------------------------------------------------------------
@pytest.mark.parametrize("B,S,H,P,G,N,chunk,hb", [
    (2, 128, 8, 16, 2, 8, 32, 4),
    (1, 256, 4, 32, 1, 16, 64, 4),   # single group (zamba2 style)
    (2, 64, 8, 64, 8, 32, 32, 8),    # per-head groups
])
def test_mamba2_plain_matches_pallas_interpret(B, S, H, P, G, N, chunk, hb):
    jargs, targs = mamba2_inputs(np.random.default_rng(0), B, S, H, P, G, N)
    want_y, want_h = j_mamba2_scan(*jargs, chunk=chunk, head_block=hb, interpret=True)
    for y, h in (m2.mamba2_scan(*targs), ops.mamba2(*targs, impl="cuda"),
                 ops.mamba2(*targs, impl="ref")):
        assert y.dtype == torch.float32 and tuple(y.shape) == (B, S, H, P)
        close(y, want_y, 1e-4)
        close(h, want_h, 1e-4)
    # the token recurrences of both packages agree, and with the kernel
    ny, nh = ref.mamba2_scan_naive(*targs)
    jy, jh = jref.mamba2_scan_naive(*jargs)
    close(ny, jy, 1e-4)
    close(nh, jh, 1e-4)
    close(ny, want_y, 1e-4)


def test_mamba2_bf16_and_zero_state_match_jax_chunked():
    """bf16 x/B/C (the reference rounds C.B to bf16 in its chunked form, as
    the port's plain version does) and the default zero initial state."""
    jargs, targs = mamba2_inputs(np.random.default_rng(1), 2, 256, 8, 32, 1, 16,
                                 jnp.bfloat16, h0=False)
    want_y, want_h = jref.mamba2_scan_chunked(*jargs, chunk=128)
    y, h = m2.mamba2_scan(*targs)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    close(y, want_y, 2e-2)
    close(h, want_h, 1e-4)


# -- rwkv6 ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,S,H,K,V,chunk,sub", [
    (2, 128, 4, 16, 16, 32, 16),
    (1, 256, 2, 64, 64, 64, 32),
    (2, 64, 8, 32, 32, 64, 32),
])
def test_rwkv6_plain_matches_pallas_interpret(B, S, H, K, V, chunk, sub):
    jargs, targs = rwkv6_inputs(np.random.default_rng(2), B, S, H, K, V)
    want_y, want_s = j_rwkv6_scan(*jargs, chunk=chunk, sub=sub, interpret=True)
    for y, s in (r6.rwkv6_scan(*targs), ops.rwkv6(*targs[:5], s0=targs[5], impl="cuda"),
                 ops.rwkv6(*targs[:5], s0=targs[5], impl="ref")):
        assert y.dtype == torch.float32 and tuple(y.shape) == (B, S, H, V)
        close(y, want_y, 5e-5)
        close(s, want_s, 5e-5)
    # and the chunked math equals the token recurrences of both packages
    ny, ns = ref.rwkv6_scan_naive(*targs)
    jy, js = jref.rwkv6_scan_naive(*jargs)
    close(ny, jy, 1e-4)
    close(ns, js, 1e-4)
    close(ny, want_y, 2e-3)


def test_rwkv6_off_grid_decay_matches_jax_recurrence():
    """w off the 2^-6 grid: the plain version against the JAX token
    recurrence at the reference's 2e-3 (which has no prefix sums)."""
    jargs, targs = rwkv6_inputs(np.random.default_rng(10), 2, 256, 4, 32, 32, grid=False)
    y, s = r6.rwkv6_scan(*targs)
    want_y, want_s = jref.rwkv6_scan_naive(*jargs)
    close(y, want_y, 2e-3)
    close(s, want_s, 2e-3)


def test_rwkv6_bf16_and_strong_decay_match_jax():
    """bf16 r/k/v, and channels decaying by up to exp(-8) a step: the
    per-(t, s, k) decay exponent stays <= 0, so nothing overflows."""
    rng = np.random.default_rng(3)
    jargs, targs = rwkv6_inputs(rng, 2, 128, 4, 32, 32, jnp.bfloat16)
    want_y, want_s = jref.rwkv6_scan_chunked(*jargs, chunk=64)
    y, s = r6.rwkv6_scan(*targs)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    close(y, want_y, 2e-2)
    close(s, want_s, 5e-5)
    jargs, targs = rwkv6_inputs(rng, 1, 128, 2, 64, 64, w_max=8.0)
    y, s = r6.rwkv6_scan(*targs)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    close(y, jref.rwkv6_scan_chunked(*jargs, chunk=64)[0], 5e-5)
    close(y, jref.rwkv6_scan_naive(*jargs)[0], 2e-3)


# -- decode steps -----------------------------------------------------------------------
def test_decode_steps_match_jax():
    rng = np.random.default_rng(4)
    B, H, P, G, N = 3, 4, 8, 2, 8
    (jx, x), (jdt, dt), (jA, A) = normal(rng, (B, H, P)), uniform(rng, 0.01, 0.2, (B, H)), \
        both(jnp.asarray(-rng.uniform(0.5, 2, H).astype(np.float32)))
    (jb, b), (jc, c), (jh, h) = normal(rng, (B, G, N)), normal(rng, (B, G, N)), \
        normal(rng, (B, H, P, N))
    for got, want in zip(ops.mamba2_decode(x, dt, A, b, c, h),
                         jref.mamba2_decode_step(jx, jdt, jA, jb, jc, jh)):
        close(got, want, 1e-5)
    K = 8
    (jr, r), (jk, k), (jv, v), (js, s) = normal(rng, (B, H, K)), normal(rng, (B, H, K)), \
        normal(rng, (B, H, K)), normal(rng, (B, H, K, K))
    (jw, w), (ju, u) = uniform(rng, -1.0, -0.05, (B, H, K)), normal(rng, (H, K))
    for got, want in zip(ops.rwkv6_decode(r, k, v, w, u, s),
                         jref.rwkv6_decode_step(jr, jk, jv, jw, ju, js)):
        close(got, want, 1e-5)


def test_mamba2_decode_equals_scan():
    """Twin of the reference's check: stepping token by token reproduces
    the scan (here the port's wrapper, its plain version on the CPU)."""
    B, S, H, P, G, N = 2, 16, 4, 8, 2, 8
    _, (x, dt, A, Bm, Cm, _) = mamba2_inputs(np.random.default_rng(5), B, S, H, P, G, N)
    y, hfin = m2.mamba2_scan(x, dt, A, Bm, Cm)
    h = torch.zeros((B, H, P, N))
    for t in range(S):
        yt, h = ops.mamba2_decode(x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t], h)
        torch.testing.assert_close(yt, y[:, t], atol=3e-5, rtol=3e-5)
    torch.testing.assert_close(h, hfin, atol=3e-5, rtol=3e-5)


def test_rwkv6_decode_equals_scan():
    B, S, H, K = 2, 16, 4, 8
    _, (r, k, v, _, u, _) = rwkv6_inputs(np.random.default_rng(6), B, S, H, K, K)
    w = -torch.from_numpy(np.random.default_rng(7).uniform(0.05, 1.0, (B, S, H, K))
                          .astype(np.float32))
    y, sfin = r6.rwkv6_scan(r, k, v, w, u)
    s = torch.zeros((B, H, K, K))
    for t in range(S):
        yt, s = ops.rwkv6_decode(r[:, t], k[:, t], v[:, t], w[:, t], u, s)
        torch.testing.assert_close(yt, y[:, t], atol=3e-5, rtol=3e-5)
    torch.testing.assert_close(s, sfin, atol=3e-5, rtol=3e-5)


# -- the reference's rules and the wrappers' checks -------------------------------------
def test_chunked_references_refuse_a_ragged_sequence():
    """The plain versions keep the reference's rule S % chunk == 0 (the CUDA
    kernels mask a ragged last chunk instead)."""
    _, targs = mamba2_inputs(np.random.default_rng(8), 1, 200, 2, 16, 1, 16)
    with pytest.raises(ValueError, match="S must divide chunk"):
        m2.mamba2_scan(*targs)
    _, targs = rwkv6_inputs(np.random.default_rng(9), 1, 100, 2, 16, 16)
    with pytest.raises(ValueError, match="S must divide chunk"):
        r6.rwkv6_scan(*targs)


@pytest.mark.parametrize("call", [
    lambda: m2.mamba2_scan(torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3), torch.zeros(3),
                           torch.zeros(1, 8, 2, 16), torch.zeros(1, 8, 2, 16)),   # H % G
    lambda: m2.mamba2_scan(torch.zeros(1, 8, 2, 16), torch.zeros(1, 8, 2), torch.zeros(2),
                           torch.zeros(1, 8, 1, 16), torch.zeros(1, 8, 1, 8)),    # B != C
    lambda: m2.mamba2_scan(torch.zeros(1, 8, 2, 16), torch.zeros(1, 8, 2), torch.zeros(2),
                           torch.zeros(1, 8, 1, 16), torch.zeros(1, 8, 1, 16),
                           torch.zeros(1, 2, 16, 8)),                             # h0 shape
    lambda: r6.rwkv6_scan(torch.zeros(1, 8, 2, 16), torch.zeros(1, 8, 2, 16),
                          torch.zeros(1, 8, 2, 16), torch.zeros(1, 8, 2, 16),
                          torch.zeros(3, 16)),                                    # u shape
    lambda: r6.rwkv6_scan(torch.zeros(1, 8, 2, 16), torch.zeros(1, 8, 2, 16),
                          torch.zeros(1, 8, 2, 16, dtype=torch.bfloat16),
                          torch.zeros(1, 8, 2, 16), torch.zeros(2, 16)),          # v dtype
    lambda: ops.mamba2(torch.zeros(1, 8, 2, 16), torch.zeros(1, 8, 2), torch.zeros(2),
                       torch.zeros(1, 8, 1, 16), torch.zeros(1, 8, 1, 16), impl="pallas"),
])
def test_scan_wrappers_refuse_bad_input(call):
    with pytest.raises((ValueError, TypeError)):
        call()
