"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: skips without a GPU.  Imports no JAX, so it runs on a
machine with the card:  PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
chip_smoke.py runs the same comparison at the serve shapes.
"""

import pytest
import torch

from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa


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
