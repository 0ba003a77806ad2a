"""Why the fp32 flash kernel makes each product as three tf32 products.

``csrc/flash_attention.cu`` runs fp32 attention on the tensor cores, whose
fp32 path takes tf32 operands (10 explicit mantissa bits).  It splits each
fp32 operand x into hi = tf32(x) and lo = tf32(x - hi) and sums lo hi +
hi lo + hi hi (3xTF32).  ``chip_smoke.py`` emulates that arithmetic in
plain torch (``tf32_round``, ``attention_tf32_split``) and holds the
emulation, beside the kernel, against the plain version on the card.
Here, on the CPU, the same emulation is loaded from ``chip_smoke.py`` and
held against the JAX package's flash kernel in interpret mode at the fp32
limit that the card holds the kernel to (2e-5): three terms meet it, one
tf32 pass does not.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_fwd as j_flash_attention_fwd

# the test workers share the machine's cores: two intra-op threads each keep
# torch from starving the others (tests/test_system.py times wall clocks)
torch.set_num_threads(2)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke_for_split", Path(__file__).resolve().parents[1] / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

TOL = cs.TOL["float32"]  # atol = rtol, the fp32 kernel's limit on the card
SHAPES = [  # (B, H, KV, S, T, D, causal)
    (1, 4, 2, 128, 128, 64, True),
    (1, 2, 2, 64, 64, 128, False),
    (2, 4, 2, 47, 150, 64, False),    # ragged, S < T
    (1, 4, 1, 100, 130, 128, True),   # ragged, causal at offset T - S
]


def _bits(*patterns):
    return torch.tensor(np.array(patterns, dtype=np.uint32).view(np.int32)).view(torch.float32)


def _pattern(x):
    return x.view(torch.int32).numpy().view(np.uint32).tolist()


def test_tf32_round_keeps_values_with_13_zero_low_bits():
    rng = np.random.default_rng(0)
    pats = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32) & 0xFFFFE000
    pats = pats[(pats & 0x7F800000) != 0x7F800000]  # finite values only
    x = _bits(*pats.tolist(), 0, 0x80000000, 0x00002000, 0x7F7FE000)
    assert _pattern(cs.tf32_round(torch, x)) == _pattern(x)


@pytest.mark.parametrize("sign", [0, 0x80000000])
def test_tf32_round_to_nearest_ties_away_from_zero(sign):
    x = _bits(*(sign | p for p in (
        0x3F801000,    # 1 + half a tf32 ulp: a tie, away from zero
        0x3F800FFF,    # below the tie: down
        0x3F801001,    # above it: up
        0x3F803000,    # 1 + 1.5 ulp: a tie, away (not to even)
        0x3FFFF000,    # the largest tf32 below 2 plus half an ulp: carries into the exponent
    )))
    want = [sign | p for p in (0x3F802000, 0x3F800000, 0x3F802000, 0x3F804000, 0x40000000)]
    assert _pattern(cs.tf32_round(torch, x)) == want


def _inputs(B, H, KV, S, T, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((B, H, S, D), (B, KV, T, D), (B, KV, T, D))]


def _jax_kernel(q, k, v, causal):
    """The JAX package's flash kernel in interpret mode, with the largest
    blocks up to 64 that divide S and T (as tests/test_torch_kernels.py
    calls it)."""
    bq, bk = (max(d for d in range(1, 65) if n % d == 0) for n in (q.shape[2], k.shape[2]))
    out = j_flash_attention_fwd(*(jnp.asarray(x) for x in (q, k, v)), causal,
                                block_q=bq, block_k=bk, interpret=True)
    return np.asarray(out, np.float32)


def _split_error(terms, B, H, KV, S, T, D, causal):
    q, k, v = _inputs(B, H, KV, S, T, D)
    want = _jax_kernel(q, k, v, causal)
    got = cs.attention_tf32_split(torch, *(torch.from_numpy(x) for x in (q, k, v)), causal,
                                  terms).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    share = (np.abs(got - want) / (TOL + TOL * np.abs(want))).max()
    print(f"[split] {terms} term(s) {(B, H, KV, S, T, D, causal)}: max_abs_err "
          f"{np.abs(got - want).max():.3e}, {100 * share:.1f}% of the {TOL:g} limit")
    return share


@pytest.mark.parametrize("B,H,KV,S,T,D,causal", SHAPES)
def test_three_tf32_products_meet_the_fp32_limit(B, H, KV, S, T, D, causal):
    assert _split_error(3, B, H, KV, S, T, D, causal) <= 1.0


@pytest.mark.parametrize("B,H,KV,S,T,D,causal", SHAPES)
def test_one_tf32_pass_breaks_the_fp32_limit(B, H, KV, S, T, D, causal):
    assert _split_error(1, B, H, KV, S, T, D, causal) > 1.0
