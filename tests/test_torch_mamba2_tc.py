"""The bf16 Mamba2 kernel's arithmetic, transcribed in torch.

``csrc/mamba2_scan.cu`` (bf16) runs each chunk of L = 64 positions as four
tensor-core products on bf16 operands with fp32 accumulation.  With cs the
inclusive cumsum of dt A over the chunk:

    CB  = C B^T                                     (C, B bf16 inputs: exact)
    W   = exp(cs_t - cs_s) dt_s CB[t][s], s <= t    (in the accumulators)
    y   = exp(cs_t) (C h^T) + W x                   (h, W in two bf16 parts)
    h'  = exp(cs_L) h + x^T B~,  B~_s = exp(cs_L - cs_s) dt_s B_s
                                                    (B~ in two bf16 parts)

exp(cs_t) scales the accumulator's rows; it is not folded into C.  (The
kernel forms W's exponentials as powers of 2 of the cumsum in log2 units:
the same values up to fp32 rounding.)  A ragged last chunk is zero-padded
(dt = 0 there).  The kernel runs only on the card, so that arithmetic is
transcribed here and held against the JAX package's ``mamba2_scan``
(Pallas, interpret mode) and its token recurrence on the same inputs: in
fp32 without rounding on fp32 inputs (1e-4), and with the kernel's bf16
parts on bf16 inputs (y 2e-2, state 1e-4, against fp32 arithmetic on the
same bf16 values), the limits the card holds the kernel to.  The
transcription lives in this file, not in the port: the port's CPU path is
the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.mamba2_scan import mamba2_scan as j_mamba2_scan
from repro_torch.bridge import params_from_numpy
from repro_torch.kernels import mamba2_scan as m2

# the test workers share the machine's cores: two intra-op threads each keep
# torch from starving the others (tests/test_system.py times wall clocks)
torch.set_num_threads(2)

L = m2.CHUNK


def inputs(rng, B, S, H, P, G, N, dtype):
    """tests/test_kernels.py's distributions with a nonzero h0: (the values
    in fp32 as JAX arrays, the torch arguments in ``dtype``).  x, B and C
    are rounded to ``dtype`` first, so both sides see the same values."""
    def normal(shape, dt=jnp.float32):
        return jnp.asarray(rng.normal(size=shape).astype(np.float32), dt)
    x, Bm, Cm = normal((B, S, H, P), dtype), normal((B, S, G, N), dtype), normal((B, S, G, N), dtype)
    dt = jnp.asarray(rng.uniform(0.01, 0.2, (B, S, H)).astype(np.float32))
    A = jnp.asarray(-rng.uniform(0.5, 2, H).astype(np.float32))
    h0 = normal((B, H, P, N))
    jargs = tuple(a.astype(jnp.float32) for a in (x, dt, A, Bm, Cm, h0))
    targs = tuple(params_from_numpy(np.asarray(a), "cpu") for a in (x, dt, A, Bm, Cm, h0))
    return jargs, targs


def parts(x, n):
    """x as the sum of n bf16 parts, each rounding what the earlier ones
    leave; n = 0 keeps x in fp32.  The kernel multiplies each part and sums
    the products in fp32: the same as the product of this sum, up to the
    order of the fp32 sums."""
    if n == 0:
        return x
    out = torch.zeros_like(x)
    for _ in range(n):
        p = (x - out).to(torch.bfloat16).float()
        out = out + p
    return out


def tc_scan(x, dt, A, Bm, Cm, h0=None, n_w=2, n_h=2, n_bt=2):
    """What the bf16 kernel computes, chunk by chunk (L positions, the last
    one zero-padded), with W, h and B~ in ``n_w``, ``n_h`` and ``n_bt``
    bf16 parts (0: fp32, unrounded).  Returns y in x's dtype and the fp32
    final state."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    n = -(-S // L)

    def pad(t):  # (B, S, ...) -> (B, H, n L, ...), zeros past S
        t = torch.nn.functional.pad(t.float(), (0, 0) * (t.dim() - 2) + (0, n * L - S))
        if t.dim() == 4 and t.shape[2] != H:  # B, C: the group of each head
            t = t.repeat_interleave(H // t.shape[2], dim=2)
        return t.transpose(1, 2)

    xp, dtp, bp, cp = pad(x), pad(dt), pad(Bm), pad(Cm)
    h = torch.zeros(B, H, P, N) if h0 is None else h0.float().clone()
    idx = torch.arange(L)
    lower = idx[:, None] >= idx[None, :]
    ys = []
    for c in range(n):
        sl = slice(c * L, (c + 1) * L)
        xc, dc, bc, cc = xp[:, :, sl], dtp[:, :, sl], bp[:, :, sl], cp[:, :, sl]
        cs = torch.cumsum(dc * A[None, :, None], -1)          # (B, H, L)
        total = cs[..., -1:]
        wst = torch.exp(torch.clamp(total - cs, max=0.0)) * dc
        # W in the C B^T accumulators: the exponent only where s <= t
        expo = torch.where(lower, cs[..., :, None] - cs[..., None, :], -torch.inf)
        W = torch.exp(expo) * dc[..., None, :] * (cc @ bc.transpose(-1, -2))
        y = (cc @ parts(h, n_h).transpose(-1, -2)) * torch.exp(cs)[..., None]
        y = y + parts(W, n_w) @ xc
        h = torch.exp(total)[..., None] * h + xc.transpose(-1, -2) @ parts(wst[..., None] * bc, n_bt)
        ys.append(y)
    y = torch.cat(ys, 2)[:, :, :S].transpose(1, 2)
    return y.to(x.dtype), h


def close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def share(got, want, tol):
    """The largest share of atol = rtol = tol that any element uses."""
    want = want.float()
    return ((got.float() - want).abs() / (tol + tol * want.abs())).max().item()


# (B, S, H, P, G, N): P 16 and 64, N 16 and 64, G 1 and G = H
SHAPES = [(2, 256, 4, 64, 1, 64), (2, 128, 4, 16, 4, 16), (1, 192, 2, 16, 1, 64),
          (2, 128, 4, 64, 4, 16)]


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "B{}S{}H{}P{}G{}N{}".format(*s))
def test_tc_scan_matches_pallas_interpret(shape, dtype):
    """S a multiple of the chunk, nonzero h0: the transcription against the
    JAX kernel in interpret mode at chunk 64 on the same values (in fp32):
    fp32 arithmetic on fp32 inputs at 1e-4; the kernel's bf16 parts on bf16
    inputs at 2e-2 for y and 1e-4 for the state."""
    B, S, H, P, G, N = shape
    jargs, targs = inputs(np.random.default_rng(S + P + N), *shape, dtype)
    want_y, want_h = j_mamba2_scan(*jargs, chunk=L, head_block=H, interpret=True)
    bf16 = dtype == jnp.bfloat16
    y, h = tc_scan(*targs, **({} if bf16 else {"n_w": 0, "n_h": 0, "n_bt": 0}))
    assert y.dtype == (torch.bfloat16 if bf16 else torch.float32)
    close(y, want_y, 2e-2 if bf16 else 1e-4)
    close(h, want_h, 1e-4)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 200, 2, 64, 1, 64), (2, 100, 4, 16, 4, 16),
                                   (1, 65, 2, 64, 2, 16), (2, 1, 2, 16, 1, 64)],
                         ids=lambda s: "B{}S{}H{}P{}G{}N{}".format(*s))
def test_tc_scan_ragged_matches_the_recurrence(shape, dtype):
    """A ragged last chunk (S = 200, 100, 65, 1), zero-padded: against the
    JAX token recurrence in fp32 on the same values, at the same limits."""
    jargs, targs = inputs(np.random.default_rng(shape[1]), *shape, dtype)
    want_y, want_h = jref.mamba2_scan_naive(*jargs)
    bf16 = dtype == jnp.bfloat16
    y, h = tc_scan(*targs, **({} if bf16 else {"n_w": 0, "n_h": 0, "n_bt": 0}))
    close(y, want_y, 2e-2 if bf16 else 1e-4)
    close(h, want_h, 1e-4)


def test_bf16_parts_meet_the_card_limits_and_one_part_of_b_tilde_does_not():
    """zamba2's head shape (P = N = 64, G = 1), bf16 inputs: with the
    kernel's parts, y within 2e-2 and the state within 1e-4 of the port's
    plain version in fp32 on the same bf16 values (the card's check).  With
    B~ = wst B in one bf16 part the state misses 1e-4."""
    _, targs = inputs(np.random.default_rng(3), 2, 512, 4, 64, 1, 64, jnp.bfloat16)
    want_y, want_h = m2.mamba2_plain(*(t.float() for t in targs))
    y, h = tc_scan(*targs)
    assert share(y, want_y, 2e-2) <= 1.0
    assert share(h, want_h, 1e-4) <= 1.0
    _, h_one = tc_scan(*targs, n_bt=1)
    assert share(h_one, want_h, 1e-4) > 1.0
