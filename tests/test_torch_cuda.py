"""The port's CUDA kernels against their plain versions, on the card.

These tests import no JAX, so they run on a machine that has only PyTorch
and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

A CUDA kernel has no CPU mode: on a host without a card every test here
skips (the ``cuda`` marker), and tests/test_torch_kernels.py holds the
plain versions against the JAX reference instead.
"""

import pytest
import torch

from repro_torch.kernels import ref as tref
from repro_torch.kernels.gemm import gemm
from repro_torch.kernels.reduce_nway import reduce_nway

TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 128, 128, 128), (3, 200, 77, 130), (1, 1, 1, 1)])
@pytest.mark.parametrize("accumulate", [False, True])
def test_gemm_kernel_matches_plain_on_card(card, shape, dt, accumulate):
    B, M, K, N = shape
    gen = torch.Generator(device=card).manual_seed(0)
    a, b, c = (torch.randn(B, *s, generator=gen, device=card).to(TDT[dt])
               for s in ((M, K), (K, N), (M, N)))
    before = gemm.launches
    out = gemm(a, b, c, accumulate=accumulate)
    torch.cuda.synchronize()
    assert gemm.launches == before + 1 and out.is_cuda
    ref = tref.gemm_ref(a, b, c, accumulate=accumulate)
    # f32: another summation order; bf16: one ulp of the rounded output
    tol = 1e-4 if dt == "f32" else 2e-2
    scale = max(1.0, ref.float().abs().max().item())
    assert (out.float() - ref.float()).abs().max().item() <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("op,dtype", [("add", torch.float32), ("add", torch.bfloat16),
                                      ("add", torch.int32), ("max", torch.float32),
                                      ("max", torch.bfloat16), ("and", torch.int32)])
@pytest.mark.parametrize("shape,dim", [((5, 4096), 0), ((8, 1001), 0), ((3, 6, 7, 40), 1)])
def test_reduce_kernel_matches_plain_on_card(card, op, dtype, shape, dim):
    gen = torch.Generator(device=card).manual_seed(1)
    if dtype == torch.int32:
        x = torch.randint(0, 2 if op == "and" else 100, shape, generator=gen,
                          device=card, dtype=torch.int32)
    else:
        x = torch.randn(shape, generator=gen, device=card).to(dtype)
    before = reduce_nway.launches
    out = reduce_nway(x, op=op, dim=dim)
    torch.cuda.synchronize()
    assert reduce_nway.launches == before + 1 and out.is_cuda
    ref = tref.reduce_nway_ref(x, op, dim)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_kernels_reject_non_contiguous_on_card(card):
    a = torch.zeros(16, 8, device=card).t()
    with pytest.raises(ValueError):
        gemm(a, torch.zeros(16, 4, device=card))
    with pytest.raises(ValueError):
        reduce_nway(a)
