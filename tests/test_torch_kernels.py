"""Port attention kernels vs the JAX reference on the same inputs.

On the CPU the port's kernel wrappers run their plain versions; they are
held against the JAX Pallas kernels in interpret mode (the kernel bodies
executing on the CPU) at the shapes and tolerances of tests/test_kernels.py,
and, for ragged lengths the TPU kernels refuse, against the JAX oracles.
The CUDA kernels themselves are held against the plain versions on the
card by chip_smoke.py and by tests/test_torch_cuda.py.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import flash_decode as j_flash_decode
from repro.kernels.flash_attention import flash_attention_fwd as j_flash_attention_fwd
from repro_torch.bridge import params_from_numpy
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

TOL = {jnp.float32: 2e-5, jnp.bfloat16: 2e-2}


def rnd(rng, shape, dtype=jnp.float32):
    """The same values as a JAX array and as a CPU tensor (bit-identical,
    bf16 included)."""
    x = jnp.asarray(rng.normal(size=shape).astype(np.float32), dtype)
    return x, params_from_numpy(np.asarray(x), "cpu")


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
    assert ops.launch_counts() == {"flash_attention_fwd": 0, "flash_decode": 0}


# -- flash attention ------------------------------------------------------------
@pytest.mark.parametrize("B,H,KV,S,T,D,causal", [
    (1, 4, 4, 128, 128, 64, True),
    (2, 8, 2, 128, 256, 64, True),     # GQA + cross lengths
    (1, 2, 1, 256, 256, 128, False),   # MQA, non-causal
    (1, 4, 2, 128, 128, 256, True),    # gemma-size head_dim
])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_flash_attention_matches_pallas_interpret(B, H, KV, S, T, D, causal, dtype):
    rng = np.random.default_rng(0)
    (jq, q), (jk, k), (jv, v) = (rnd(rng, (B, H, S, D), dtype), rnd(rng, (B, KV, T, D), dtype),
                                 rnd(rng, (B, KV, T, D), dtype))
    want = j_flash_attention_fwd(jq, jk, jv, causal, block_q=64, block_k=64, interpret=True)
    got = fa.flash_attention_fwd(q, k, v, causal)
    assert got.dtype == q.dtype and got.shape == q.shape
    close(got, want, TOL[dtype])
    close(ops.attention(q, k, v, causal, impl="cuda"), want, TOL[dtype])


@pytest.mark.parametrize("B,H,KV,S,T,D", [
    (2, 4, 2, 130, 257, 64),    # S != T, neither a multiple of a block
    (1, 4, 1, 300, 300, 128),
])
def test_flash_attention_ragged_matches_jax_blockwise(B, H, KV, S, T, D):
    rng = np.random.default_rng(1)
    (jq, q), (jk, k), (jv, v) = rnd(rng, (B, H, S, D)), rnd(rng, (B, KV, T, D)), rnd(rng, (B, KV, T, D))
    want = jref.attention_blockwise(jq, jk, jv, True, block_q=128, block_k=128)
    close(fa.flash_attention_fwd(q, k, v, True), want, 2e-5)
    close(ref.attention_blockwise(q, k, v, True, block_q=128, block_k=128), want, 2e-5)
    close(ref.attention_naive(q, k, v, True), jref.attention_naive(jq, jk, jv, True), 2e-5)


def test_flash_attention_rows_without_keys_are_zero():
    """Causal with S > T: the first S - T rows see no key.  The reference
    oracles give those rows a uniform average; the kernels give zeros."""
    rng = np.random.default_rng(2)
    (_, q), (_, k), (_, v) = rnd(rng, (1, 4, 100, 64)), rnd(rng, (1, 2, 60, 64)), rnd(rng, (1, 2, 60, 64))
    out = fa.flash_attention_fwd(q, k, v, True)
    assert torch.count_nonzero(out[:, :, :40]) == 0
    # the rows that do see keys agree with the naive oracle
    close(out[:, :, 40:], ref.attention_naive(q, k, v, True)[:, :, 40:].numpy(), 2e-5)


# -- decode attention -------------------------------------------------------------
@pytest.mark.parametrize("B,H,KV,T,D", [
    (2, 8, 2, 512, 64), (1, 4, 1, 1024, 128), (3, 6, 6, 512, 64)])
def test_flash_decode_matches_pallas_interpret(B, H, KV, T, D):
    rng = np.random.default_rng(3)
    (jq, q), (jk, k), (jv, v) = rnd(rng, (B, H, D)), rnd(rng, (B, KV, T, D)), rnd(rng, (B, KV, T, D))
    length = rng.integers(1, T + 1, B).astype(np.int32)
    want = j_flash_decode(jq, jk, jv, jnp.asarray(length), block_k=128, interpret=True)
    got = dec.flash_decode(q, k, v, torch.from_numpy(length))
    close(got, want, 2e-5)
    close(ops.decode_attention(q, k, v, torch.from_numpy(length), impl="cuda"), want, 2e-5)


def test_flash_decode_bf16_and_ragged_cache_match_jax():
    """bf16, a cache length no block divides, and lengths 1 and T."""
    rng = np.random.default_rng(4)
    B, H, KV, T, D = 3, 8, 2, 77, 64
    for dtype in (jnp.float32, jnp.bfloat16):
        (jq, q), (jk, k), (jv, v) = (rnd(rng, (B, H, D), dtype), rnd(rng, (B, KV, T, D), dtype),
                                     rnd(rng, (B, KV, T, D), dtype))
        length = np.array([1, T, 40], np.int32)
        want = jref.decode_attention_naive(jq, jk, jv, jnp.asarray(length))
        close(dec.flash_decode(q, k, v, torch.from_numpy(length)), want, TOL[dtype])
        close(ref.decode_attention_naive(q, k, v, torch.from_numpy(length)), want, TOL[dtype])


def test_flash_decode_length_zero_is_zero():
    rng = np.random.default_rng(5)
    (_, q), (_, k), (_, v) = rnd(rng, (2, 4, 64)), rnd(rng, (2, 2, 16, 64)), rnd(rng, (2, 2, 16, 64))
    out = dec.flash_decode(q, k, v, torch.tensor([0, 7], dtype=torch.int32))
    assert torch.count_nonzero(out[0]) == 0 and torch.count_nonzero(out[1]) > 0


def test_strided_views_take_the_plain_path_unchanged():
    """The model hands (B,S,H,D) activations and the (B,T,KV,D) cache over
    as transposed views; results equal those of contiguous copies."""
    rng = np.random.default_rng(6)
    _, x = rnd(rng, (2, 40, 4, 64))
    _, c = rnd(rng, (2, 50, 2, 64))
    q, k = x.transpose(1, 2), c.transpose(1, 2)
    torch.testing.assert_close(fa.flash_attention_fwd(q, k, k, True),
                               fa.flash_attention_fwd(q.contiguous(), k.contiguous(),
                                                      k.contiguous(), True))
    length = torch.tensor([50, 3], dtype=torch.int32)
    torch.testing.assert_close(dec.flash_decode(q[:, :, 0], k, k, length),
                               dec.flash_decode(q[:, :, 0].contiguous(), k.contiguous(),
                                                k.contiguous(), length))


@pytest.mark.parametrize("call", [
    lambda: fa.flash_attention_fwd(torch.zeros(1, 4, 8, 64), torch.zeros(1, 3, 8, 64),
                                   torch.zeros(1, 3, 8, 64)),           # H % KV
    lambda: fa.flash_attention_fwd(torch.zeros(1, 4, 8, 64), torch.zeros(1, 2, 8, 32),
                                   torch.zeros(1, 2, 8, 32)),           # head_dim
    lambda: dec.flash_decode(torch.zeros(2, 4, 64), torch.zeros(2, 2, 8, 64),
                             torch.zeros(2, 2, 8, 64), torch.zeros(3, dtype=torch.int32)),
    lambda: ops.attention(torch.zeros(1, 2, 4, 64), torch.zeros(1, 2, 4, 64),
                          torch.zeros(1, 2, 4, 64), impl="pallas"),
])
def test_wrappers_refuse_bad_input(call):
    with pytest.raises((ValueError, TypeError)):
        call()
