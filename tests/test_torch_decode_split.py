"""The flash-decode kernel's split of the cache axis, transcribed in torch.

``csrc/decode_attention.cu`` splits ``[0, length[b])`` of each (batch, kv
head) pair over the C CTAs of a cluster and, inside a CTA, over its warps;
each warp runs an online softmax over its chunks of 16 keys, and the
partials (m, l, o) are merged by log-sum-exp, first per CTA, then across
the cluster.  The kernel runs only on the card, so its partition and its
merges are transcribed here, step for step in fp32, and held at 2e-5
against the JAX package's ``flash_decode`` (Pallas, interpret mode) and
its oracle ``decode_attention_naive``.  The transcription lives in this
file, not in the port: the port's CPU path is the plain version.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import flash_decode as j_flash_decode
from repro_torch.kernels import decode_attention as dec

# the test workers share the machine's cores: two intra-op threads each keep
# torch from starving the others (tests/test_system.py times wall clocks)
torch.set_num_threads(2)

TOL = 2e-5
T_RAGGED = 600  # a multiple of neither the 16-key chunk nor the 64-key tile
KV, D = 2, 64


def _partial(q, k, v, scale):
    """One warp: online softmax over its keys, CHUNK at a time; (m, l, o)
    with m = -inf, l = 0, o = 0 when it has no key."""
    G = q.shape[0]
    m = torch.full((G,), -math.inf)
    l, o = torch.zeros(G), torch.zeros(G, v.shape[-1])
    for c0 in range(0, k.shape[0], dec.CHUNK):
        s = q @ k[c0:c0 + dec.CHUNK].T * scale
        mn = torch.maximum(m, s.max(-1).values)
        corr = torch.exp(m - mn)
        p = torch.exp(s - mn[:, None])
        l = l * corr + p.sum(-1)
        o = o * corr[:, None] + p @ v[c0:c0 + dec.CHUNK]
        m = mn
    return m, l, o


def _merge(parts, correct_max=True):
    """Log-sum-exp merge; a part with m = -inf weighs 0, and the largest m
    is taken as 0 when every part is empty.  ``correct_max=False`` sums
    the parts without rescaling them to a common max (a planted fault)."""
    m = torch.stack([p[0] for p in parts])
    mx = m.max(0).values
    mu = torch.where(mx == -math.inf, torch.zeros_like(mx), mx)
    w = torch.exp(m - mu) if correct_max else torch.ones_like(m)
    l = sum(wi * p[1] for wi, p in zip(w, parts))
    o = sum(wi[:, None] * p[2] for wi, p in zip(w, parts))
    return mx, l, o


def split_decode(q, k, v, length, C, correct_max=True):
    """The kernel's arithmetic in fp32: warp w of CTA r takes the chunks
    [(r W + w) per, (r W + w + 1) per) of ceil(n / CHUNK), with per =
    ceil(ceil(n / CHUNK) / (C W)); warps merge per CTA, CTAs per pair."""
    B, H, Dh = q.shape
    nkv, T = k.shape[1], k.shape[2]
    G = H // nkv
    out = torch.zeros(B, H, Dh)
    for b in range(B):
        n = min(max(int(length[b]), 0), T)
        per = -(-(-(-n // dec.CHUNK)) // (C * dec.WARPS))
        for h in range(nkv):
            qg, kb, vb = q[b, h * G:(h + 1) * G], k[b, h], v[b, h]
            ctas = []
            for r in range(C):
                warps = []
                for w in range(dec.WARPS):
                    lo = min((r * dec.WARPS + w) * per * dec.CHUNK, n)
                    hi = min(lo + per * dec.CHUNK, n)
                    warps.append(_partial(qg, kb[lo:hi], vb[lo:hi], Dh ** -0.5))
                ctas.append(_merge(warps))
            _, l, o = _merge(ctas, correct_max)
            out[b, h * G:(h + 1) * G] = o / l.clamp_min(1e-30)[:, None]
    return out


def _lengths(C):
    """0, 1, 2, T and one below, at and one above E = TILE * C: at E every
    warp has one whole chunk; one key more doubles the slices and leaves
    the trailing CTAs empty."""
    E = dec.TILE * C
    return [0, 1, 2, E - 1, E, E + 1, T_RAGGED]


_JAX = {}


def _case(G, C, Dh=D):
    """Inputs (the same values in numpy, fp32) and the JAX kernel's output,
    computed once per (G, lengths, head_dim)."""
    lengths = _lengths(C)
    key = (G, tuple(lengths), Dh)
    if key not in _JAX:
        rng = np.random.default_rng(G)
        B = len(lengths)
        q = rng.normal(size=(B, KV * G, Dh)).astype(np.float32)
        k = rng.normal(size=(B, KV, T_RAGGED, Dh)).astype(np.float32)
        v = rng.normal(size=(B, KV, T_RAGGED, Dh)).astype(np.float32)
        ln = np.array(lengths, np.int32)
        want = j_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ln),
                              block_k=200, interpret=True)
        _JAX[key] = (q, k, v, ln, np.asarray(want))
    return _JAX[key]


@pytest.mark.parametrize("G", [1, 8])
@pytest.mark.parametrize("C", [1, 2, 3, 8])
def test_split_merge_matches_jax_kernel_and_oracle(C, G):
    _check_split_merge(C, G, D)


@pytest.mark.parametrize("G", [1, 8])
@pytest.mark.parametrize("C", [1, 2, 8])
def test_split_merge_matches_jax_kernel_at_head_dim_256(C, G):
    """Gemma's head_dim: G = 1 is gemma-7b's MHA, G = 8 gemma-2b's MQA
    group, at the G * D <= 2048 limit."""
    _check_split_merge(C, G, 256)


def _check_split_merge(C, G, Dh):
    q, k, v, ln, want = _case(G, C, Dh)
    got = split_decode(*(torch.from_numpy(x) for x in (q, k, v, ln)), C)
    assert torch.isfinite(got).all()  # empty warps and CTAs make no NaN
    assert torch.count_nonzero(got[0]) == 0  # length 0 gives zeros, as the JAX kernel
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    naive = jref.decode_attention_naive(jnp.asarray(q[1:]), jnp.asarray(k[1:]),
                                        jnp.asarray(v[1:]), jnp.asarray(ln[1:]))
    np.testing.assert_allclose(got[1:].numpy(), np.asarray(naive), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("C", [2, 8])
def test_merge_without_max_correction_is_rejected(C):
    """A planted fault: partials summed without rescaling to a common max
    miss the JAX kernel by far more than the tolerance."""
    q, k, v, ln, want = _case(8, C)
    got = split_decode(*(torch.from_numpy(x) for x in (q, k, v, ln)), C, correct_max=False)
    assert np.abs(got.numpy() - want).max() > 100 * TOL


@pytest.mark.parametrize("T", [1, 16, 64, 65, 300, 1065, 1089, 32768])
def test_split_count_bounds(T):
    tiles = -(-T // dec.TILE)
    for B in (1, 2, 3, 8, 33, 64, 1000):
        for nkv in (1, 2, 4, 8, 32):
            C = dec.split_count(B, nkv, T)
            assert 1 <= C <= dec.MAX_SPLITS and C <= tiles
            if B * nkv * dec.MAX_SPLITS <= 2 * dec.SMS and tiles >= dec.MAX_SPLITS:
                assert C == dec.MAX_SPLITS  # few pairs: a full cluster each


def test_split_count_at_the_serve_shapes():
    """About two CTAs per SM: TinyLlama's 32 pairs take clusters of 8;
    Zamba2's 256 MHA pairs, and a cache of one tile, one CTA a pair."""
    assert dec.split_count(8, 4, 1065) == 8
    assert dec.split_count(8, 32, 1089) == 1
    assert dec.split_count(8, 4, 64) == 1
    assert dec.split_count(68, 4, 1065) == 1


def test_wrapper_takes_head_dim_256_up_to_the_group_limit():
    """The CUDA path's checks (run here on CPU tensors): head_dim 64, 128
    and 256 pass while (H // KV) * D <= 2048; gemma-2b's G = 8 at D = 256
    sits at the limit, G = 16 at D = 256 and any other head_dim raise."""
    length = torch.ones(1, dtype=torch.int32)
    for H, nkv, Dh in ((8, 1, 256), (16, 16, 256), (16, 1, 128), (32, 1, 64)):
        q, k = torch.zeros(1, H, Dh), torch.zeros(1, nkv, 16, Dh)
        dec._check_cuda(q, k, k, length)
    for H, nkv, Dh, msg in ((16, 1, 256, "must be <= 2048"), (4, 1, 512, "head_dim in"),
                            (4, 1, 96, "head_dim in")):
        q, k = torch.zeros(1, H, Dh), torch.zeros(1, nkv, 16, Dh)
        with pytest.raises(ValueError, match=msg):
            dec._check_cuda(q, k, k, length)
