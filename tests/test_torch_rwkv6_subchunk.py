"""The bf16 RWKV6 kernel's arithmetic, transcribed in torch.

``csrc/rwkv6_scan.cu`` (bf16) forms the chunk's pair matrix per (t, s, k)
only inside diagonal sub-blocks of SUB positions, and there without an
exponential per pair: walking down column s, the decayed k_s is
multiplied by one more exp(w_j) a row,

    k_s exp(cwx_t - cw_s) = k_s prod_{s<j<t} exp(w_j),

eight lanes walking column sa = i0 + cp and then, from its own start,
column sb = i0 + SUB - 1 - cp.  Off the diagonal sub-blocks it factors the
decay about a sub-block boundary a (s <= a < t),

    exp(cwx_t - cw_s) = exp(cwx_t - cw_a) * exp(cw_a - cw_s),

halving the chunk recursively (rows 16..31 x columns 0..15 about 15, then
each half about its own middle), and folds the decays into r and k for
the two state products.  On the card every product runs on bf16 operands
split into two or three bf16 parts.  The kernel runs only on the card, so
that arithmetic is transcribed here: in fp32, and with the kernel's bf16
splits, and held against the JAX package's ``rwkv6_scan`` (Pallas,
interpret mode), its token recurrence, and the port's plain version.  The
kernel is built with SUB = 8; sub = 16 is the same design at the other
sub-block size.  The transcription lives in this file, not in the port:
the port's CPU path is the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.rwkv6_scan import rwkv6_scan as j_rwkv6_scan
from repro_torch.bridge import params_from_numpy
from repro_torch.kernels import rwkv6_scan as r6

# the test workers share the machine's cores: two intra-op threads each keep
# torch from starving the others (tests/test_system.py times wall clocks)
torch.set_num_threads(2)

L = r6.CHUNK


def both(x):
    return x, params_from_numpy(np.asarray(x), "cpu")


def inputs(rng, B, S, H, K, dtype=jnp.float32, w_max=3.0, grid=True):
    """tests/test_kernels.py's distributions; with ``grid`` w lies on the
    2^-6 grid, where every prefix sum of w is exact in fp32."""
    def normal(shape, dt=jnp.float32):
        return both(jnp.asarray(rng.normal(size=shape).astype(np.float32), dt))
    r, k, v = normal((B, S, H, K), dtype), normal((B, S, H, K), dtype), normal((B, S, H, K), dtype)
    w = -rng.uniform(0.01, w_max, (B, S, H, K))
    if grid:
        w = -np.maximum(np.round(-w * 64), 1) / 64
    w = both(jnp.asarray(w.astype(np.float32)))
    u, s0 = normal((H, K)), normal((B, H, K, K))
    return tuple(zip(r, k, v, w, u, s0))  # (jax args, torch args)


def factored_blocks(lo, hi, sub):
    """(t0, t1, s0, s1, a) of every block formed in factored form: the
    lower-left quadrant of [lo, hi) about its middle, then each half."""
    if hi - lo <= sub:
        return []
    mid = (lo + hi) // 2
    return [(mid, hi, lo, mid, mid - 1)] + factored_blocks(lo, mid, sub) \
        + factored_blocks(mid, hi, sub)


def parts(x, n):
    """x as n bf16 parts, each rounding what the earlier ones leave."""
    out = []
    for _ in range(n):
        p = x.to(torch.bfloat16).float()
        out.append(p)
        x = x - p
    return out


def split_mm(a, b, na, nb):
    """a @ b over the bf16 parts of both, as the kernel sums its mma.sync
    products: the part pairs (i, j) with i + j < max(na, nb)."""
    pa, pb = parts(a, na), parts(b, nb)
    return sum(pa[i] @ pb[j] for i in range(na) for j in range(nb) if i + j < max(na, nb))


class Exps:
    """torch.exp that records the largest exponent it is given."""

    def __init__(self):
        self.largest = -float("inf")

    def __call__(self, x):
        if x.numel():
            self.largest = max(self.largest, x.max().item())
        return torch.exp(x)


def diagonal_walk(rc, kc, dec, i0, sub, A):
    """A[t][s] for s < t inside the diagonal sub-block at i0, as the kernel's
    lanes form it: the lanes of column pair cp walk down column sa, then
    switch to column sb and walk down it from its own start, multiplying
    the decayed k by dec = exp(w) of the row above at each step."""
    for cp in range(sub // 2):
        sa, sb, na = i0 + cp, i0 + sub - 1 - cp, sub - 1 - cp
        kd = kc[:, :, sa]
        for j in range(sub - 1):
            on_a = j < na
            s = sa if on_a else sb
            t = s + 1 + (j if on_a else j - na)
            if j == na:  # column sb starts here
                kd = kc[:, :, sb]
            elif j > 0:  # one more row of decay
                kd = kd * dec[:, :, t - 1]
            A[:, :, t, s] = (rc[:, :, t] * kd).sum(-1)


def subchunk_scan(r, k, v, w, u, s0=None, sub=8, split=False, exp=torch.exp):
    """What the bf16 kernel computes, chunk by chunk (L positions, the last
    one zero-padded).  ``split`` rounds the products' operands into the
    kernel's bf16 parts: S^T r~^T over 2 x 2 parts, A v over A's two parts,
    v^T k~ over k~'s three, the factored pair blocks over 2 x 2."""
    B, S, H, K = r.shape
    n = -(-S // L)

    def pad(x):  # (B, S, H, X) -> (B, H, n L, X), zeros past S
        return torch.nn.functional.pad(x.float().permute(0, 2, 1, 3), (0, 0, 0, n * L - S))
    rp, kp, vp, wp = pad(r), pad(k), pad(v), pad(w)
    s = torch.zeros(B, H, K, v.shape[-1]) if s0 is None else s0.float().clone()
    mm = (lambda a, b, na, nb: split_mm(a, b, na, nb)) if split else \
        (lambda a, b, na, nb: a @ b)
    ys = []
    for c in range(n):
        rc, kc, vc, wc = (x[:, :, c * L:(c + 1) * L] for x in (rp, kp, vp, wp))
        cw = torch.cumsum(wc, 2)
        cwx = torch.cat([torch.zeros_like(cw[:, :, :1]), cw[:, :, :-1]], 2)  # cw_{t-1}
        dec = exp(wc)
        A = torch.zeros(B, H, L, L)
        for i0 in range(0, L, sub):  # diagonal sub-blocks: the decay walk
            diagonal_walk(rc, kc, dec, i0, sub, A)
        idx = torch.arange(L)
        A[:, :, idx, idx] = (rc * u[None, :, None, :] * kc).sum(-1)  # the bonus
        for t0, t1, c0, c1, a in factored_blocks(0, L, sub):
            rf = rc[:, :, t0:t1] * exp(cwx[:, :, t0:t1] - cw[:, :, a:a + 1])
            kf = kc[:, :, c0:c1] * exp(cw[:, :, a:a + 1] - cw[:, :, c0:c1])
            A[:, :, t0:t1, c0:c1] = mm(rf, kf.transpose(-1, -2), 2, 2)
        rt = rc * exp(cwx)
        kt = kc * exp(cw[:, :, -1:] - cw)
        ys.append(mm(rt, s, 2, 2) + mm(A, vc, 2, 1))
        s = exp(cw[:, :, -1])[..., None] * s + mm(kt.transpose(-1, -2), vc, 3, 1)
    y = torch.cat(ys, 2)[:, :, :S].permute(0, 2, 1, 3)
    return y.to(v.dtype), s


def close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_factored_blocks_cover_the_pairs_off_the_diagonal_sub_blocks():
    """Every pair s < t is written exactly once: by the decay walk of one
    diagonal sub-block, or in one factored block, whose anchor a satisfies
    s <= a < t."""
    class Writes:  # counts the pair matrix entries the walk writes
        def __init__(self):
            self.n = torch.zeros(L, L, dtype=torch.int32)

        def __setitem__(self, idx, value):
            self.n[idx[2], idx[3]] += 1

    ones = torch.ones(1, 1, L, 1)
    for sub in (8, 16):
        writes = Writes()
        for i0 in range(0, L, sub):
            diagonal_walk(ones, ones, ones, i0, sub, writes)
        seen = writes.n
        for t0, t1, c0, c1, a in factored_blocks(0, L, sub):
            assert c1 - 1 <= a < t0
            seen[t0:t1, c0:c1] += 1
        assert torch.equal(seen, torch.tril(torch.ones(L, L, dtype=torch.int32), -1))
    assert factored_blocks(0, L, 8) == [(16, 32, 0, 16, 15), (8, 16, 0, 8, 7),
                                        (24, 32, 16, 24, 23)]


@pytest.mark.parametrize("sub", [8, 16])
@pytest.mark.parametrize("S,K,chunk", [(96, 64, 32), (80, 16, 16)])
def test_subchunk_scan_matches_pallas_interpret_on_the_grid(sub, S, K, chunk):
    """fp32, w on the 2^-6 grid, nonzero s0: at 5e-5 against the JAX
    kernel in interpret mode (S = 80 is ragged for the chunk of 32 and
    zero-padded; the JAX kernel takes it in chunks of 16)."""
    jargs, targs = inputs(np.random.default_rng(sub + S), 2, S, 2, K)
    want_y, want_s = j_rwkv6_scan(*jargs, chunk=chunk, sub=min(sub, chunk), interpret=True)
    exp = Exps()
    y, s = subchunk_scan(*targs, sub=sub, exp=exp)
    assert exp.largest <= 0.0
    close(y, want_y, 5e-5)
    close(s, want_s, 5e-5)


@pytest.mark.parametrize("w_max", [3.0, 8.0, 20.0])
@pytest.mark.parametrize("split", [False, True])
def test_subchunk_scan_off_the_grid_matches_the_recurrence(w_max, split):
    """w off the grid, channels decaying by up to exp(-20) a step (the
    model's range): finite, no positive exponent, and the state within 2e-3
    of the JAX token recurrence; y too in fp32, and within the bf16 limit
    2e-2 with the kernel's bf16 splits on bf16 r, k, v (the recurrence in
    fp32 on the same values)."""
    dtype = jnp.bfloat16 if split else jnp.float32
    jargs, targs = inputs(np.random.default_rng(int(w_max)), 2, 100, 2, 64, dtype,
                          w_max=w_max, grid=False)
    want_y, want_s = jref.rwkv6_scan_naive(*(x.astype(jnp.float32) for x in jargs))
    exp = Exps()
    y, s = subchunk_scan(*targs, sub=8, split=split, exp=exp)
    assert exp.largest <= 0.0
    assert torch.isfinite(y.float()).all() and torch.isfinite(s).all()
    close(y, want_y, 2e-2 if split else 2e-3)
    close(s, want_s, 2e-3)


@pytest.mark.parametrize("sub", [8, 16])
def test_bf16_splits_meet_the_card_limits(sub):
    """bf16 r, k, v and the kernel's bf16 operand splits: y within 2e-2 and
    the final state within 5e-5 of the plain version in fp32 on the same
    bf16 values, the limits the card holds the kernel to.  k~ rounded to
    bf16 alone (one part) misses the state limit."""
    jargs, targs = inputs(np.random.default_rng(7), 2, 256, 2, 64, jnp.bfloat16)
    r, k, v, w, u, s0 = targs
    want_y, want_s = r6.rwkv6_plain(r.float(), k.float(), v.float(), w, u, s0)
    y, s = subchunk_scan(*targs, sub=sub, split=True)
    assert y.dtype == torch.bfloat16
    close(y, want_y, 2e-2)
    close(s, want_s, 5e-5)
    # the shortcut: the state update over k~'s first bf16 part only
    cw = torch.cumsum(w.float().permute(0, 2, 1, 3).reshape(2, 2, -1, L, 64), 3)
    assert cw.shape[2] == 256 // L
    s_short = s0.float().clone()
    vv = v.float().permute(0, 2, 1, 3).reshape(2, 2, -1, L, 64)
    kk = k.float().permute(0, 2, 1, 3).reshape(2, 2, -1, L, 64)
    for c in range(256 // L):
        kt = (kk[:, :, c] * torch.exp(cw[:, :, c, -1:] - cw[:, :, c])).to(torch.bfloat16).float()
        s_short = torch.exp(cw[:, :, c, -1])[..., None] * s_short + kt.transpose(-1, -2) @ vv[:, :, c]
    err = (s_short - want_s).abs() - 5e-5 * (1 + want_s.abs())
    assert err.max().item() > 0
