"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: skips without a GPU.  Imports no JAX, so it runs on a
machine with the card:  PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
chip_smoke.py runs the same comparison at the serve shapes.
"""

import pytest
import torch

from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba2_scan as m2
from repro_torch.kernels import ref
from repro_torch.kernels import rwkv6_scan as r6

# the test workers share the machine's cores: two intra-op threads each keep
# torch from starving the others (tests/test_system.py times wall clocks)
torch.set_num_threads(2)


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions_on_the_card():
    """bf16 and fp32, ragged lengths, strided views; each call launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    g = torch.Generator(device="cuda").manual_seed(0)
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-5)):
        q = torch.randn(2, 130, 8, 64, generator=g, device="cuda").to(dtype).transpose(1, 2)
        k = torch.randn(2, 257, 2, 64, generator=g, device="cuda").to(dtype).transpose(1, 2)
        before = fa.launches
        torch.testing.assert_close(fa.flash_attention_fwd(q, k, k, True),
                                   fa.attention_plain(q, k, k, True), atol=tol, rtol=tol)
        assert fa.launches == before + 1
        length = torch.tensor([1, 257], dtype=torch.int32, device="cuda")
        before = dec.launches
        torch.testing.assert_close(dec.flash_decode(q[:, :, 0], k, k, length),
                                   dec.decode_plain(q[:, :, 0], k, k, length),
                                   atol=tol, rtol=tol)
        assert dec.launches == before + 1


@pytest.mark.cuda
def test_cuda_flash_attention_tile_edges_on_the_card():
    """The flash kernel at its tile edges (128 query rows, 64 keys a tile),
    with S > T (rows that see no key are zeros) and at D = 128 and 192
    with KV = H, in bf16 and fp32, against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    g = torch.Generator(device="cuda").manual_seed(1)
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-5)):
        for B, H, KV, S, T, D in ((2, 4, 2, 129, 129, 64), (2, 4, 2, 100, 60, 64),
                                  (1, 4, 4, 129, 129, 128), (1, 4, 4, 129, 129, 192),
                                  (1, 4, 4, 130, 257, 192)):
            q = torch.randn(B, S, H, D, generator=g, device="cuda").to(dtype).transpose(1, 2)
            k = torch.randn(B, T, KV, D, generator=g, device="cuda").to(dtype).transpose(1, 2)
            v = torch.randn(B, T, KV, D, generator=g, device="cuda").to(dtype).transpose(1, 2)
            before = fa.launches
            got = fa.flash_attention_fwd(q, k, v, True)
            assert fa.launches == before + 1
            torch.testing.assert_close(got, fa.attention_plain(q, k, v, True),
                                       atol=tol, rtol=tol)
            if S > T:
                assert got[:, :, :S - T].abs().max().item() == 0.0


@pytest.mark.cuda
def test_cuda_flash_attention_full_on_the_card():
    """The flash kernel full (non-causal), as the encoder-decoder calls it:
    S = T across the tile edges (the encoder) and S < T with a ragged last
    key tile (the cross-attention), in bf16 and fp32, against its plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    g = torch.Generator(device="cuda").manual_seed(4)
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-5)):
        for B, H, KV, S, T, D in ((2, 6, 6, 47, 150, 64), (1, 6, 6, 300, 300, 64),
                                  (2, 6, 6, 129, 1500, 64)):
            q = torch.randn(B, S, H, D, generator=g, device="cuda").to(dtype).transpose(1, 2)
            k = torch.randn(B, T, KV, D, generator=g, device="cuda").to(dtype).transpose(1, 2)
            v = torch.randn(B, T, KV, D, generator=g, device="cuda").to(dtype).transpose(1, 2)
            before = fa.launches
            got = fa.flash_attention_fwd(q, k, v, False)
            assert fa.launches == before + 1
            torch.testing.assert_close(got, fa.attention_plain(q, k, v, False),
                                       atol=tol, rtol=tol)


@pytest.mark.cuda
def test_cuda_flash_attention_mla_call_on_the_card():
    """MLA's prefill call at a small shape: head_dim 192 (qk_nope 128 +
    qk_rope 64), V 128 wide zero-padded to 192, scale 192^-0.5, causal and
    full, in bf16 and fp32, against the plain version; the padded columns
    of the output stay zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    g = torch.Generator(device="cuda").manual_seed(2)
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-5)):
        for causal in (True, False):
            q, k = (torch.randn(2, 129, 4, 192, generator=g, device="cuda").to(dtype)
                    .transpose(1, 2) for _ in range(2))
            v = torch.nn.functional.pad(torch.randn(2, 129, 4, 128, generator=g,
                                                    device="cuda").to(dtype), (0, 64))
            v = v.transpose(1, 2)
            before = fa.launches
            got = fa.flash_attention_fwd(q, k, v, causal, 192 ** -0.5)
            assert fa.launches == before + 1
            assert got[..., 128:].abs().max().item() == 0.0
            torch.testing.assert_close(got, fa.attention_plain(q, k, v, causal, 192 ** -0.5),
                                       atol=tol, rtol=tol)


@pytest.mark.cuda
def test_cuda_scan_kernels_match_plain_versions_on_the_card():
    """bf16 and fp32, a nonzero initial state, G > 1, strided views of one
    projection (as the model hands them over), a ragged S against the token
    recurrence; each call launches.  bf16 outputs are held against the
    plain versions run in fp32 on the same bf16 values (the kernels'
    arithmetic); RWKV6's decay lies on a 2^-6 grid so that both sides form
    the same prefix sums."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    g = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        B, S, H, P, G, N = 2, 256, 8, 32, 2, 16
        proj = rn(B, S, H * P + 2 * G * N).to(dtype)   # x | B | C, split as views
        x = proj[..., :H * P].unflatten(-1, (H, P))
        Bm = proj[..., H * P:H * P + G * N].unflatten(-1, (G, N))
        Cm = proj[..., H * P + G * N:].unflatten(-1, (G, N))
        dt = torch.rand(B, S, H, generator=g, device="cuda") * 0.19 + 0.01
        A = -(torch.rand(H, generator=g, device="cuda") * 1.5 + 0.5)
        h0 = rn(B, H, P, N)
        before = m2.launches
        y, h = m2.mamba2_scan(x, dt, A, Bm, Cm, h0)
        assert m2.launches == before + 1
        want = m2.mamba2_plain(x.float(), dt, A, Bm.float(), Cm.float(), h0)
        torch.testing.assert_close(y.float(), want[0], atol=tol, rtol=tol)
        torch.testing.assert_close(h, want[1], atol=1e-4, rtol=1e-4)
        y, h = m2.mamba2_scan(x[:, :200], dt[:, :200], A, Bm[:, :200], Cm[:, :200], h0)
        want = ref.mamba2_scan_naive(x[:, :200].float(), dt[:, :200], A,
                                     Bm[:, :200].float(), Cm[:, :200].float(), h0)
        torch.testing.assert_close(y.float(), want[0], atol=tol, rtol=tol)
        torch.testing.assert_close(h, want[1], atol=1e-4, rtol=1e-4)

        B, S, H, K = 2, 256, 4, 64
        r, k, v = rn(B, S, H, K).to(dtype), rn(B, S, H, K).to(dtype), rn(B, S, H, K).to(dtype)
        w = -torch.clamp(torch.round(torch.rand(B, S, H, K, generator=g, device="cuda")
                                     * 3 * 64), min=1) / 64
        u, s0 = rn(H, K), rn(B, H, K, K)
        before = r6.launches
        y, s = r6.rwkv6_scan(r, k, v, w, u, s0)
        assert r6.launches == before + 1
        want = r6.rwkv6_plain(r.float(), k.float(), v.float(), w, u, s0)
        rtol = 5e-5 if dtype == torch.float32 else tol
        torch.testing.assert_close(y.float(), want[0], atol=rtol, rtol=rtol)
        torch.testing.assert_close(s, want[1], atol=5e-5, rtol=5e-5)
        y, s = r6.rwkv6_scan(r[:, :200], k[:, :200], v[:, :200], w[:, :200], u, s0)
        want = ref.rwkv6_scan_naive(r[:, :200].float(), k[:, :200].float(),
                                    v[:, :200].float(), w[:, :200], u, s0)
        ntol = 2e-3 if dtype == torch.float32 else tol
        torch.testing.assert_close(y.float(), want[0], atol=ntol, rtol=ntol)
        torch.testing.assert_close(s, want[1], atol=2e-3, rtol=2e-3)


@pytest.mark.cuda
def test_cuda_flash_decode_split_edges_on_the_card():
    """The decode kernel at the edges of its split of the cache over C CTAs
    a pair: lengths 0, 1, 2 and T, one below, at and one above E = TILE * C
    (one whole chunk a warp; one key more doubles the slices and empties
    the trailing CTAs), C = 1, G = 1 and 8 at D = 128, G = 32 at D = 64; a
    cache whose K and V are strided views of one (B, T, 2, KV, D) buffer;
    bf16 and fp32; each call is one counted launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    g = torch.Generator(device="cuda").manual_seed(2)
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-5)):
        for B, H, KV, T, D in ((8, 32, 4, 1065, 64), (2, 8, 2, 60, 64), (2, 8, 8, 300, 128),
                               (2, 16, 2, 300, 128), (2, 32, 1, 200, 64)):
            E = dec.TILE * dec.split_count(B, KV, T)
            lengths = [0, 1, 2, E - 1, E, E + 1, 100, T] if B == 8 else [T, min(E + 1, T)]
            q = torch.randn(B, H, D, generator=g, device="cuda").to(dtype)
            kv = torch.randn(B, T, 2, KV, D, generator=g, device="cuda").to(dtype)
            k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
            length = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            before = dec.launches
            got = dec.flash_decode(q, k, v, length)
            assert dec.launches == before + 1
            torch.testing.assert_close(got, dec.decode_plain(q, k, v, length),
                                       atol=tol, rtol=tol)
            if lengths[0] == 0:
                assert got[0].abs().max().item() == 0.0


@pytest.mark.cuda
def test_cuda_flash_decode_head_dim_256_edges_on_the_card():
    """The decode kernel at head_dim 256 (Gemma; Q staged in shared memory):
    gemma-7b's MHA and gemma-2b's MQA serve shapes (G = 1 and 8, the
    latter at the G * D <= 2048 limit) and a small ragged cache, lengths 0,
    1, 2, T and one below, at and one above E = TILE * C; bf16 and fp32
    against the plain version, bf16 also against a dense fp32 reference on
    the same values; each call is one counted launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    g = torch.Generator(device="cuda").manual_seed(4)
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-5)):
        for B, H, KV, T in ((8, 16, 16, 1065), (8, 8, 1, 1065), (3, 8, 1, 77)):
            E = dec.TILE * dec.split_count(B, KV, T)
            lengths = ([0, 1, 2, E - 1, E, E + 1, 100, T] if B == 8 else [T, 1, min(E + 1, T)])
            q = torch.randn(B, H, 256, generator=g, device="cuda").to(dtype)
            k = torch.randn(B, T, KV, 256, generator=g, device="cuda").to(dtype).transpose(1, 2)
            v = torch.randn(B, T, KV, 256, generator=g, device="cuda").to(dtype).transpose(1, 2)
            length = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            before = dec.launches
            got = dec.flash_decode(q, k, v, length)
            assert dec.launches == before + 1
            torch.testing.assert_close(got, dec.decode_plain(q, k, v, length),
                                       atol=tol, rtol=tol)
            if dtype == torch.bfloat16:
                want = dec.decode_plain(q.float(), k.float(), v.float(), length)
                torch.testing.assert_close(got.float(), want, atol=5e-3, rtol=1e-2)
            if lengths[0] == 0:
                assert got[0].abs().max().item() == 0.0


@pytest.mark.cuda
def test_cuda_rwkv6_scan_edges_on_the_card():
    """The RWKV6 kernels at the edges of the bf16 kernel's chunk and
    sub-blocks (S = 1, SUB - 1, SUB + 1, CHUNK + 1), at K = V = 16, 32 and
    64, and on r/k/v that are views of one projection, with rows 16-byte
    aligned (cp.async staging) and not (plain loads); bf16 and fp32, y and
    the final state (at 5e-5 in both dtypes) against the plain version in
    fp32 on the same values, w on the 2^-6 grid; each call is one counted
    launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    g = torch.Generator(device="cuda").manual_seed(3)
    # (B, S, H, K, offset): with an offset, r/k/v are views that start that
    # many elements into one (B, S, 3 H K + offset) projection
    cases = [(2, 1, 4, 64, None), (2, r6.SUB - 1, 4, 64, None), (2, r6.SUB + 1, 4, 64, None),
             (2, r6.CHUNK + 1, 4, 64, None), (2, 128, 4, 16, None), (2, 128, 4, 32, None),
             (2, 128, 4, 64, 8), (2, 128, 4, 64, 1), (2, r6.CHUNK + 1, 4, 16, 1)]
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 5e-5)):
        for B, S, H, K, offset in cases:
            if offset is not None:
                proj = torch.randn(B, S, 3 * H * K + offset, generator=g,
                                   device="cuda").to(dtype)
                r, k, v = (proj[..., offset + i * H * K:offset + (i + 1) * H * K]
                           .unflatten(-1, (H, K)) for i in range(3))
            else:
                r, k, v = (torch.randn(B, S, H, K, generator=g, device="cuda").to(dtype)
                           for _ in range(3))
            w = -torch.clamp(torch.round(torch.rand(B, S, H, K, generator=g, device="cuda")
                                         * 3 * 64), min=1) / 64
            u = torch.randn(H, K, generator=g, device="cuda")
            s0 = torch.randn(B, H, K, K, generator=g, device="cuda")
            before = r6.launches
            y, s = r6.rwkv6_scan(r, k, v, w, u, s0)
            assert r6.launches == before + 1
            want = r6.rwkv6_plain(r.float(), k.float(), v.float(), w, u, s0)
            torch.testing.assert_close(y.float(), want[0], atol=tol, rtol=tol)
            torch.testing.assert_close(s, want[1], atol=5e-5, rtol=5e-5)


@pytest.mark.cuda
def test_cuda_mamba2_scan_edges_on_the_card():
    """The Mamba2 kernels at the edges of the bf16 kernel's chunk (S = 1,
    CHUNK - 1, CHUNK + 1, 1000), at P = 16 and 32, N = 16, 32 and 128
    (zero-padded tiles; two panels), G = H, and on x/B/C that are views of
    one projection with rows 16-byte aligned (cp.async staging) and not
    (plain loads); bf16 and fp32, a nonzero h0, y against the plain version
    in fp32 on the same values (the token recurrence for a ragged S), the
    final state at 1e-4 in both dtypes; each call is one counted launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    g = torch.Generator(device="cuda").manual_seed(4)
    L = m2.CHUNK
    # (B, S, H, P, G, N, offset): with an offset, x/B/C are views that start
    # that many elements into one (B, S, H P + 2 G N + offset) projection
    cases = [(2, 1, 4, 64, 1, 64, None), (2, L - 1, 4, 64, 1, 64, None),
             (2, L + 1, 4, 64, 1, 64, None), (2, 1000, 2, 64, 1, 64, None),
             (2, 128, 4, 16, 1, 64, None), (2, 128, 4, 32, 1, 64, None),
             (2, 128, 4, 64, 1, 16, None), (2, 128, 4, 64, 1, 32, None),
             (2, 128, 4, 64, 1, 128, None), (2, 128, 4, 64, 4, 64, None),
             (2, 128, 4, 64, 1, 64, 8), (2, 128, 4, 64, 1, 64, 1),
             (2, L + 1, 4, 16, 4, 16, 1)]
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        for B, S, H, P, G, N, offset in cases:
            proj = torch.randn(B, S, H * P + 2 * G * N + (offset or 0), generator=g,
                               device="cuda").to(dtype)
            o = offset or 0
            x = proj[..., o:o + H * P].unflatten(-1, (H, P))
            Bm = proj[..., o + H * P:o + H * P + G * N].unflatten(-1, (G, N))
            Cm = proj[..., o + H * P + G * N:].unflatten(-1, (G, N))
            dt = torch.rand(B, S, H, generator=g, device="cuda") * 0.19 + 0.01
            A = -(torch.rand(H, generator=g, device="cuda") * 1.5 + 0.5)
            h0 = torch.randn(B, H, P, N, generator=g, device="cuda")
            before = m2.launches
            y, h = m2.mamba2_scan(x, dt, A, Bm, Cm, h0)
            assert m2.launches == before + 1
            args = (x.float(), dt, A, Bm.float(), Cm.float(), h0)
            want = m2.mamba2_plain(*args) if S % 128 == 0 else ref.mamba2_scan_naive(*args)
            torch.testing.assert_close(y.float(), want[0].float(), atol=tol, rtol=tol)
            torch.testing.assert_close(h, want[1], atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_cuda_train_steps_match_the_plain_path_on_the_card():
    """Per ported architecture at smoke size in fp32 (attention head_dim 64,
    which the flash kernel takes; deepseek-v2's MLA at qk_nope 128 +
    qk_rope 64 = 192): two train steps on the kernel path
    against the plain path from the same state, every state leaf at 1e-4;
    each step launches each kernel once per layer.  Then the three autograd
    Functions (kernel forward, plain backward) against plain autograd at
    the reference's custom-VJP limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    from dataclasses import replace

    from repro_torch.bridge import leaf_names
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_train_state, make_train_step
    from repro_torch.models import build_model
    from repro_torch.models.config import MLAConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.tree import tree_leaves

    # eps 1e-3: the update is continuous at the grads' scale (see
    # tests/test_torch_train.py)
    opt = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10, eps=1e-3)
    wide = {"tinyllama-1.1b": dict(n_heads=2, n_kv_heads=1), "zamba2-1.2b": dict(head_dim=64),
            "rwkv6-7b": {},
            "deepseek-v2-236b": dict(mla=MLAConfig(q_lora=64, kv_lora=32, qk_nope=128,
                                                   qk_rope=64, v_head=16))}
    for arch, kw in wide.items():
        cfg = replace(get_config(arch, smoke=True), **kw)
        g = torch.Generator(device="cuda").manual_seed(5)
        batches = [{"tokens": torch.randint(0, cfg.vocab_size, (2, 128), generator=g,
                                            device="cuda"),
                    "labels": torch.randint(0, cfg.vocab_size, (2, 128), generator=g,
                                            device="cuda")} for _ in range(2)]
        n = {k: sum(b == k for b in cfg.blocks) for k in ("attn", "shared_attn", "mla",
                                                         "mamba2", "rwkv6")}
        want = {"flash_attention_fwd": n["attn"] + n["shared_attn"] + n["mla"],
                "flash_decode": 0,
                "mamba2_scan": n["mamba2"], "rwkv6_scan": n["rwkv6"]}
        states = []
        for impl in ("cuda", "ref"):
            model = build_model(replace(cfg, attn_impl=impl, scan_impl=impl))
            state = make_train_state(model, opt, torch.Generator(device="cuda").manual_seed(0))
            step = make_train_step(model, opt)
            for batch in batches:
                ops.reset_launch_counts()
                state, met = step(state, batch)
                counts = ops.launch_counts()
                assert counts == (want if impl == "cuda" else dict.fromkeys(want, 0)), arch
                assert torch.isfinite(met["loss"])
            states.append(state)
        for name, a, b in zip(leaf_names(states[0]), tree_leaves(states[0]),
                              tree_leaves(states[1])):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4, msg=f"{arch} {name}")

    # small shapes, as the reference's custom-VJP tests (the kernels take
    # D = 64 and P, N, K = 16), two chunks of each plain backward
    g = torch.Generator(device="cuda").manual_seed(6)
    q = torch.randn(1, 128, 4, 64, generator=g, device="cuda").transpose(1, 2)
    k, v = (torch.randn(1, 128, 2, 64, generator=g, device="cuda").transpose(1, 2)
            for _ in range(2))
    x = torch.randn(1, 256, 2, 16, generator=g, device="cuda")
    dt = torch.rand(1, 256, 2, generator=g, device="cuda") * 0.19 + 0.01
    A = -(torch.rand(2, generator=g, device="cuda") * 1.5 + 0.5)
    Bm, Cm = (torch.randn(1, 256, 1, 16, generator=g, device="cuda") for _ in range(2))
    r, kk, vv = (torch.randn(1, 128, 2, 16, generator=g, device="cuda") for _ in range(3))
    w = -torch.clamp(torch.round(torch.rand(1, 128, 2, 16, generator=g, device="cuda")
                                 * 3 * 64), min=1) / 64
    u = torch.randn(2, 16, generator=g, device="cuda")
    for fn, args, tol, name in ((ops.attention, (q, k, v), 2e-4, "flash_attention_fwd"),
                                (ops.mamba2, (x, dt, A, Bm, Cm), 2e-3, "mamba2_scan"),
                                (ops.rwkv6, (r, kk, vv, w, u), 2e-3, "rwkv6_scan")):
        grads = []
        for impl in ("cuda", "ref"):
            xs = [t.detach().requires_grad_() for t in args]
            before = ops.launch_counts()[name]
            outs = fn(*xs, impl=impl)
            assert ops.launch_counts()[name] == before + (impl == "cuda")
            outs = outs if isinstance(outs, tuple) else (outs,)
            grads.append(torch.autograd.grad(sum((o ** 2).sum() for o in outs), xs))
        for a, b in zip(*grads):
            torch.testing.assert_close(a, b, atol=tol, rtol=tol, msg=name)
