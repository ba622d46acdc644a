"""The port's CUDA kernels against their plain versions, on the card.

These tests import no JAX, so they run on a machine that has only PyTorch
and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

A CUDA kernel has no CPU mode: on a host without a card every test here
skips (the ``cuda`` marker), and tests/test_torch_kernels.py holds the
plain versions against the JAX reference instead.
"""

import copy
import math

import pytest
import torch

from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gemm import gemm
from repro_torch.kernels.reduce_nway import reduce_nway
from repro_torch.kernels.rglru import rglru_scan
from repro_torch.kernels.rwkv6 import wkv

TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _route_moved(wrapper, before):
    return {r: n - before[r] for r, n in wrapper.route_launches.items()}


# (B, M, K, N): bf16 takes the tensor-core route when K % 8 == N % 8 == 0
# (batched; ragged M and N tiles; K = 8; the SUMMA step), else the CUDA-core
# one (K = 77, 333, 1); f32 always the CUDA-core one.
@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 128, 128, 128), (3, 200, 77, 130), (1, 1, 1, 1),
                                   (3, 200, 72, 136), (1, 64, 8, 64), (16, 1024, 1024, 2752),
                                   (1, 100, 333, 64)])
@pytest.mark.parametrize("accumulate", [False, True])
def test_gemm_kernel_matches_plain_on_card(card, shape, dt, accumulate):
    B, M, K, N = shape
    gen = torch.Generator(device=card).manual_seed(0)
    a, b, c = (torch.randn(B, *s, generator=gen, device=card).to(TDT[dt])
               for s in ((M, K), (K, N), (M, N)))
    route = "tensor_core" if dt == "bf16" and K % 8 == 0 and N % 8 == 0 else "cuda_core"
    before, routes = gemm.launches, dict(gemm.route_launches)
    out = gemm(a, b, c, accumulate=accumulate)
    torch.cuda.synchronize()
    assert gemm.launches == before + 1 and out.is_cuda
    assert _route_moved(gemm, routes) == {r: int(r == route) for r in routes}
    ref = tref.gemm_ref(a, b, c, accumulate=accumulate)
    # f32: another summation order; bf16: one ulp of the rounded output
    tol = 1e-4 if dt == "f32" else 2e-2
    scale = max(1.0, ref.float().abs().max().item())
    assert (out.float() - ref.float()).abs().max().item() <= tol * scale


# (B, M, K, N) f32 on each launch plan of the CUDA-core kernel: 128 tiles
# (the SUMMA step; K = 333 with scalar loads), 64 tiles (ragged; N = 777
# and K = 333 load scalars, 332 x 776 vectors), and an operand at an
# address that is not 16-byte aligned.
@pytest.mark.cuda
@pytest.mark.parametrize("shape,plan", [((16, 1024, 1024, 2752), (128, True)),
                                        ((16, 1024, 333, 2752), (128, False)),
                                        ((1, 1000, 332, 776), (64, True)),
                                        ((1, 1000, 333, 777), (64, False)),
                                        ((3, 200, 77, 130), (64, False))])
@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("aligned", [True, False])
def test_gemm_f32_plans_match_plain_on_card(card, shape, plan, accumulate, aligned):
    from repro_torch.kernels.gemm import gemm_plan, sm_count

    B, M, K, N = shape
    gen = torch.Generator(device=card).manual_seed(8)

    def operand(*s):
        x = torch.randn(*s, generator=gen, device=card)
        if aligned:
            return x
        buf = torch.empty(x.numel() + 1, device=card)  # one float in: 4-byte aligned
        return buf[1:].view(*s).copy_(x)

    a, b, c = operand(B, M, K), operand(B, K, N), operand(B, M, N)
    ptrs = [t.data_ptr() for t in (a, b, c)]
    want = plan if aligned else (plan[0], False)
    assert gemm_plan(B, M, N, K, sm_count(card.index or 0), ptrs) == want
    out = gemm(a, b, c, accumulate=accumulate)
    torch.cuda.synchronize()
    ref = tref.gemm_ref(a, b, c, accumulate=accumulate)
    scale = max(1.0, ref.abs().max().item())
    assert (out - ref).abs().max().item() <= 1e-4 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("op,dtype", [("add", torch.float32), ("add", torch.bfloat16),
                                      ("add", torch.int32), ("max", torch.float32),
                                      ("max", torch.bfloat16), ("and", torch.int32),
                                      ("max", torch.int32), ("and", torch.bool)])
@pytest.mark.parametrize("shape,dim", [((5, 4096), 0), ((8, 1001), 0), ((3, 6, 7, 40), 1)])
def test_reduce_kernel_matches_plain_on_card(card, op, dtype, shape, dim):
    gen = torch.Generator(device=card).manual_seed(1)
    if dtype == torch.bool:
        x = torch.rand(shape, generator=gen, device=card) < 0.8
    elif op == "max" and dtype == torch.int32:  # the whole range: exact above 2^24
        x = torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=gen, device=card,
                          dtype=torch.int32)
    elif dtype == torch.int32:
        x = torch.randint(0, 2 if op == "and" else 100, shape, generator=gen,
                          device=card, dtype=torch.int32)
    else:
        x = torch.randn(shape, generator=gen, device=card).to(dtype)
    before = reduce_nway.launches
    out = reduce_nway(x, op=op, dim=dim)
    torch.cuda.synchronize()
    assert reduce_nway.launches == before + 1 and out.is_cuda
    ref = tref.reduce_nway_ref(x, op, dim)
    assert out.dtype == x.dtype
    if dtype in (torch.int32, torch.bool) and op != "add":
        assert torch.equal(out, ref)
        return
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("accumulate", [False, True])
def test_gemm_cuda_core_route_on_a_tensor_core_shape_on_card(card, accumulate):
    """The private route argument: the CUDA-core kernel on a bf16 shape the
    tensor-core one takes gives the same result, counted on its route."""
    gen = torch.Generator(device=card).manual_seed(6)
    a, b, c = (torch.randn(2, *s, generator=gen, device=card).to(torch.bfloat16)
               for s in ((256, 128), (128, 192), (256, 192)))
    routes = dict(gemm.route_launches)
    fast = gemm(a, b, c, accumulate=accumulate)
    slow = gemm(a, b, c, accumulate=accumulate, _route="cuda_core")
    torch.cuda.synchronize()
    assert _route_moved(gemm, routes) == {"cuda_core": 1, "tensor_core": 1}
    ref = tref.gemm_ref(a, b, c, accumulate=accumulate).float()
    for out in (fast, slow):  # one bf16 ulp, element by element
        assert bool(((out.float() - ref).abs() <= 2.0 ** -7 * ref.abs() + 1e-3).all())
    with pytest.raises(ValueError):  # K = 333 is not the tensor-core route's
        gemm(torch.zeros(4, 333, device=card, dtype=torch.bfloat16),
             torch.zeros(333, 8, device=card, dtype=torch.bfloat16), _route="tensor_core")


@pytest.mark.cuda
def test_kernels_reject_non_contiguous_on_card(card):
    a = torch.zeros(16, 8, device=card).t()
    with pytest.raises(ValueError):
        gemm(a, torch.zeros(16, 4, device=card))
    with pytest.raises(ValueError):
        reduce_nway(a)


# bf16 at d in (64, 128, 256) takes the tensor-core route, f32 and d = 16
# the mma_sync one.
@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("d", [16, 64, 128, 256])
@pytest.mark.parametrize("S,window", [(256, 0), (256, 48), (200, 0), (77, 16), (2048, 0),
                                      (2048, 1024)])
def test_flash_kernel_matches_plain_on_card(card, d, S, window, dt):
    gen = torch.Generator(device=card).manual_seed(2)
    q, k, v = (torch.randn(3, S, d, generator=gen, device=card).to(TDT[dt]) for _ in range(3))
    route = "tensor_core" if dt == "bf16" and d in (64, 128, 256) else "mma_sync"
    before, routes = flash_attention.launches, dict(flash_attention.route_launches)
    out = flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1 and out.is_cuda and out.dtype == q.dtype
    assert _route_moved(flash_attention, routes) == {r: int(r == route) for r in routes}
    ref = tref.flash_attention_ref(q, k, v, window=window)
    # f32: another summation order; bf16: one ulp of the rounded output
    tol = 2e-4 if dt == "f32" else 2e-2
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("d,S,window", [(64, 77, 0), (128, 200, 16), (256, 2048, 1024)])
def test_flash_routes_agree_on_card(card, d, S, window):
    """Both routes on one bf16 input, each within one bf16 ulp of the plain
    version element by element, each counted on its route."""
    gen = torch.Generator(device=card).manual_seed(7)
    q, k, v = (torch.randn(2, S, d, generator=gen, device=card).to(torch.bfloat16)
               for _ in range(3))
    routes = dict(flash_attention.route_launches)
    fast = flash_attention(q, k, v, window=window)
    slow = flash_attention(q, k, v, window=window, _route="mma_sync")
    torch.cuda.synchronize()
    assert _route_moved(flash_attention, routes) == {"mma_sync": 1, "tensor_core": 1}
    ref = tref.flash_attention_ref(q, k, v, window=window).float()
    for out in (fast, slow):
        assert bool(((out.float() - ref).abs() <= 2.0 ** -7 * ref.abs() + 1e-5).all())
    with pytest.raises(ValueError):  # f32 is not the tensor-core route's
        flash_attention(q.float(), k.float(), v.float(), _route="tensor_core")


# f32 at every head dim, held at the limit of chip_smoke.py (1e-4 of
# max(1, max|ref|)): causal, windowed, ragged S, and operands at an address
# that is not 16-byte aligned (copied for the kernel's 16-byte copies).
@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("S,window", [(1, 0), (130, 0), (300, 70), (1000, 0)])
@pytest.mark.parametrize("aligned", [True, False])
def test_flash_mma_f32_at_the_chip_limit_on_card(card, d, S, window, aligned):
    gen = torch.Generator(device=card).manual_seed(12)

    def operand():
        x = torch.randn(2, S, d, generator=gen, device=card)
        if aligned:
            return x
        buf = torch.empty(x.numel() + 1, device=card)
        return buf[1:].view(x.shape).copy_(x)

    q, k, v = operand(), operand(), operand()
    out = flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    ref = tref.flash_attention_ref(q, k, v, window=window)
    scale = max(1.0, ref.abs().max().item())
    assert (out - ref).abs().max().item() <= 1e-4 * scale


# Mixed float dtypes take the f32 kernels and return the reference's dtype.
@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["gemm", "flash_attention", "rglru_scan"])
@pytest.mark.parametrize("first", ["f32", "bf16"])
def test_mixed_dtype_wrappers_match_plain_on_card(card, kernel, first):
    other = "bf16" if first == "f32" else "f32"
    gen = torch.Generator(device=card).manual_seed(13)

    def rand(*shape, dt):
        return torch.randn(*shape, generator=gen, device=card).to(TDT[dt])

    if kernel == "gemm":
        a, b, c = rand(3, 200, 72, dt=first), rand(3, 72, 136, dt=first), rand(3, 200, 136,
                                                                                dt=other)
        out, ref = gemm(a, b, c, accumulate=True), tref.gemm_ref(a, b, c, accumulate=True)
    elif kernel == "flash_attention":
        q, k, v = rand(4, 300, 64, dt=first), rand(4, 300, 64, dt=other), rand(4, 300, 64,
                                                                                dt=other)
        out = flash_attention(q, k, v, window=100)
        ref = tref.flash_attention_ref(q.float(), k.float(), v.float(), window=100)
    else:
        a = torch.sigmoid(2 * torch.randn(2, 257, 96, generator=gen, device=card)).to(TDT[first])
        b = rand(2, 257, 96, dt=other)
        out, ref = rglru_scan(a, b), tref.rglru_scan_ref(a.float(), b.float())
    torch.cuda.synchronize()
    assert out.dtype == TDT[first] and out.is_cuda
    ref = ref.to(TDT[first]).float()
    if first == "f32":  # another summation order, relative to max(1, max|ref|)
        assert (out - ref).abs().max().item() <= 1e-4 * max(1.0, ref.abs().max().item())
    else:  # the f32 result rounded once: one bf16 ulp, element by element
        assert bool(((out.float() - ref).abs() <= 2.0 ** -7 * ref.abs() + 1e-3).all())


@pytest.mark.cuda
def test_flash_kernel_rejects_bad_operands_on_card(card):
    q = torch.zeros(2, 64, 32, device=card)
    with pytest.raises(ValueError):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), q, q)
    with pytest.raises(TypeError):
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):
        flash_attention(torch.zeros(2, 64, 48, device=card), torch.zeros(2, 64, 48, device=card),
                        torch.zeros(2, 64, 48, device=card))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["yi_6b", "gemma3_12b", "moonshot_v1_16b"])
def test_smoke_model_prefill_and_decode_on_card(card, arch):
    """A smoke config's prefill runs through the kernel, and decode after it
    matches a longer prefill (the KV-cache gate; the MoE without capacity
    drops, as the reference's gate)."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as tt

    cfg = get_smoke_config(arch)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=64.0)
    model = tt.init(torch.Generator(device=card).manual_seed(0), cfg)
    tokens = torch.randint(0, cfg.vocab, (2, 17), generator=torch.Generator(device=card)
                           .manual_seed(1), device=card)
    before = flash_attention.launches
    full, _ = tt.prefill(model, tokens, cfg, max_len=17)
    _, cache = tt.prefill(model, tokens[:, :16], cfg, max_len=17)
    assert flash_attention.launches == before + 2 * cfg.n_layers
    dec, _ = tt.decode_step(model, cache, tokens[:, 16:], 16, cfg)
    torch.cuda.synchronize()
    assert full.is_cuda and bool(torch.isfinite(dec).all())
    assert (dec - full).abs().max().item() <= 2e-4


@pytest.mark.cuda
def test_whisper_smoke_prefill_and_decode_on_card(card):
    """The decoder's causal self-attention runs through the kernel, and
    decode after a prefill matches a longer prefill."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import whisper

    cfg = get_smoke_config("whisper_base")
    gen = torch.Generator(device=card).manual_seed(0)
    model = whisper.init(gen, cfg)
    frames = torch.randn(2, cfg.encoder_len, cfg.d_model, generator=gen, device=card) * 0.1
    tokens = torch.randint(0, cfg.vocab, (2, 17), generator=gen, device=card)
    before = flash_attention.launches
    full, _ = whisper.prefill(model, {"frames": frames, "tokens": tokens}, cfg, max_len=17)
    _, cache = whisper.prefill(model, {"frames": frames, "tokens": tokens[:, :16]}, cfg,
                               max_len=17)
    assert flash_attention.launches == before + 2 * cfg.n_layers
    dec, _ = whisper.decode_step(model, cache, tokens[:, 16:], 16, cfg)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(dec).all()) and (dec - full).abs().max().item() <= 2e-4


@pytest.mark.cuda
def test_moe_is_deterministic_on_card(card):
    """Dispatch and combine use no float atomics: two bf16 calls, with
    capacity drops, give equal bits."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import mlp

    cfg = dataclasses.replace(get_config("moonshot_v1_16b"), capacity_factor=0.5)
    gen = torch.Generator(device=card).manual_seed(0)
    params = mlp.init_moe_params(gen, cfg, card)
    x = torch.randn(2, 512, cfg.d_model, generator=gen, device=card).bfloat16()
    (a, aux_a), (b, aux_b) = mlp.moe(params, x, cfg), mlp.moe(params, x, cfg)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b) and bool(torch.isfinite(a).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 256, 64), (3, 1000, 77), (1, 1, 5), (4, 129, 2560)])
def test_rglru_kernel_matches_plain_on_card(card, shape, dt):
    gen = torch.Generator(device=card).manual_seed(3)
    a = torch.sigmoid(2 * torch.randn(shape, generator=gen, device=card)).to(TDT[dt])
    b = torch.randn(shape, generator=gen, device=card).to(TDT[dt])
    before = rglru_scan.launches
    out = rglru_scan(a, b)
    torch.cuda.synchronize()
    assert rglru_scan.launches == before + 1 and out.is_cuda and out.dtype == a.dtype
    ref = tref.rglru_scan_ref(a, b)
    # f32: another association of the same products; bf16: one ulp of the output
    tol = 1e-5 if dt == "f32" else 2e-2
    scale = max(1.0, ref.float().abs().max().item())
    assert (out.float() - ref.float()).abs().max().item() <= tol * scale


@pytest.mark.cuda
def test_rglru_scratch_across_calls_on_card(card):
    """The look-back's scratch is kept between calls (a new epoch each, the
    counters back at 0 after each): shapes that grow and shrink, many calls
    in a row and a long S (a deep look-back chain) give the plain numbers."""
    gen = torch.Generator(device=card).manual_seed(14)
    for shape in [(1, 300, 64), (4, 2048, 2560), (2, 130, 96), (1, 20000, 32)] * 2:
        a = torch.sigmoid(4 + torch.randn(shape, generator=gen, device=card))
        b = torch.randn(shape, generator=gen, device=card)
        ref = tref.rglru_scan_ref(a, b)
        for _ in range(3):
            out = rglru_scan(a, b)
        torch.cuda.synchronize()
        assert (out - ref).abs().max().item() <= 1e-4 * max(1.0, ref.abs().max().item())


def _wkv_inputs(card, B, S, H, hd, dt, logw=None, seed=4):
    gen = torch.Generator(device=card).manual_seed(seed)
    r, k, v = (torch.randn(B, S, H, hd, generator=gen, device=card).to(TDT[dt]) for _ in range(3))
    if logw is None:
        lw = -torch.exp(torch.clamp(torch.randn(B, S, H, hd, generator=gen, device=card) * 2 - 3,
                                    -20.0, 2.0))
    else:
        lw = torch.full((B, S, H, hd), logw, device=card)
    u = torch.randn(H, hd, generator=gen, device=card)
    return r, k, v, lw, u


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 128, 3, 64), (1, 200, 2, 32), (3, 37, 4, 16),
                                   (1, 1, 1, 64)])
@pytest.mark.parametrize("with_state", [False, True])
def test_wkv_kernel_matches_plain_on_card(card, shape, dt, with_state):
    B, S, H, hd = shape
    r, k, v, lw, u = _wkv_inputs(card, B, S, H, hd, dt)
    s0 = (torch.randn(B, H, hd, hd, generator=torch.Generator(device=card).manual_seed(5),
                      device=card) if with_state else None)
    before = wkv.launches
    out, state = wkv(r, k, v, lw, u, s0)
    torch.cuda.synchronize()
    assert wkv.launches == before + 1 and out.is_cuda and out.dtype == r.dtype
    ref, ref_state = tref.wkv_ref(r, k, v, lw, u, s0)
    # f32: sums in another order, relative to max(1, max|ref|); bf16: the same
    # f32 result rounded once, one ulp
    tol = 1e-4 if dt == "f32" else 2e-2
    scale = max(1.0, ref.float().abs().max().item())
    assert (out.float() - ref.float()).abs().max().item() <= tol * scale
    sscale = max(1.0, ref_state.abs().max().item())
    assert (state - ref_state).abs().max().item() <= 1e-4 * sscale


# Clusters of hd / 16 blocks: (b, h) counts that are not multiples of the
# 132 SMs (135, 80, 35), ragged S, with and without state0.
@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(3, 300, 45, 64), (2, 1000, 40, 32), (5, 77, 7, 16)])
@pytest.mark.parametrize("with_state", [False, True])
def test_wkv_clusters_match_plain_on_card(card, shape, dt, with_state):
    B, S, H, hd = shape
    r, k, v, lw, u = _wkv_inputs(card, B, S, H, hd, dt, seed=9)
    s0 = (torch.randn(B, H, hd, hd, generator=torch.Generator(device=card).manual_seed(10),
                      device=card) if with_state else None)
    out, state = wkv(r, k, v, lw, u, s0)
    torch.cuda.synchronize()
    ref, ref_state = tref.wkv_ref(r, k, v, lw, u, s0)
    assert bool(torch.isfinite(out.float()).all()) and bool(torch.isfinite(state).all())
    if dt == "f32":  # another summation order, relative to max(1, max|ref|)
        scale = max(1.0, ref.abs().max().item())
        assert (out - ref).abs().max().item() <= 1e-4 * scale
    else:  # the same f32 result rounded once: one bf16 ulp, element by element
        assert bool(((out.float() - ref.float()).abs()
                     <= 2.0 ** -7 * ref.float().abs() + 1e-3).all())
    sscale = max(1.0, ref_state.abs().max().item())
    assert (state - ref_state).abs().max().item() <= 1e-4 * sscale


@pytest.mark.cuda
def test_wkv_unaligned_views_on_card(card):
    """Operands at an offset that is not a multiple of 16 bytes are copied
    to aligned tensors for the kernel's 16-byte staging: same numbers."""
    B, S, H, hd = 2, 130, 3, 32
    r, k, v, lw, u = _wkv_inputs(card, B, S, H, hd, "f32", seed=11)

    def shifted(x):
        buf = torch.empty(x.numel() + 1, device=card)
        return buf[1:].view(x.shape).copy_(x)

    out, state = wkv(shifted(r), shifted(k), shifted(v), shifted(lw), u)
    ref, ref_state = wkv(r, k, v, lw, u)
    torch.cuda.synchronize()
    assert torch.equal(out, ref) and torch.equal(state, ref_state)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,cluster", [(16, 1), (32, 2), (64, 4)])
def test_wkv_launch_info_on_card(card, hd, cluster):
    from repro_torch.kernels.rwkv6 import wkv_launch_info

    for dtype in (torch.float32, torch.bfloat16):
        info = wkv_launch_info(dtype, hd)
        assert info["cluster"] == cluster and info["max_active_clusters"] >= 1
        assert info["smem_bytes"] <= 113 * 1024  # two blocks an SM


@pytest.mark.cuda
@pytest.mark.parametrize("S", [128, 300])
def test_wkv_kernel_is_finite_at_the_strongest_decay_on_card(card, S):
    r, k, v, lw, u = _wkv_inputs(card, 2, S, 3, 64, "f32", logw=-math.e ** 2)
    out, state = wkv(r, k, v, lw, u)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(state).all())
    ref, _ = tref.wkv_ref(r, k, v, lw, u)
    scale = max(1.0, ref.abs().max().item())
    assert (out - ref).abs().max().item() <= 1e-4 * scale


@pytest.mark.cuda
def test_recurrence_kernels_reject_bad_operands_on_card(card):
    a = torch.zeros(2, 16, 8, device=card)
    with pytest.raises(ValueError):
        rglru_scan(a.transpose(1, 2).contiguous().transpose(1, 2), a)
    r = torch.zeros(1, 8, 2, 48, device=card)
    with pytest.raises(ValueError):  # head dim 48
        wkv(r, r, r, r, torch.zeros(2, 48, device=card))
    r = torch.zeros(1, 8, 2, 64, device=card)
    with pytest.raises(ValueError):
        wkv(r.transpose(1, 2).contiguous().transpose(1, 2), r, r, r, torch.zeros(2, 64, device=card))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "rwkv6_3b"])
def test_recurrent_smoke_model_on_card_matches_the_host(card, arch):
    """A smoke config's prefill on the card (through the kernels) equals the
    same weights' prefill on the host (plain versions); decode after a
    prompt longer than the hybrid's window of 8 equals the longer prefill."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_family

    cfg = get_smoke_config(arch)
    fam = get_family(cfg)
    host = fam.init(torch.Generator().manual_seed(0), cfg, "cpu")
    model = copy.deepcopy(host).to(card)
    tokens = torch.randint(0, cfg.vocab, (2, 14), generator=torch.Generator().manual_seed(1))
    counters = [rglru_scan, flash_attention] if arch == "recurrentgemma_2b" else [wkv]
    before = [c.launches for c in counters]
    full, _ = fam.prefill(model, tokens.to(card), cfg, max_len=14)
    _, cache = fam.prefill(model, tokens[:, :13].to(card), cfg, max_len=14)
    assert all(c.launches > b for c, b in zip(counters, before))
    dec, _ = fam.decode_step(model, cache, tokens[:, 13:].to(card), 13, cfg)
    torch.cuda.synchronize()
    host_full, _ = fam.prefill(host, tokens, cfg, max_len=14)
    assert full.is_cuda and bool(torch.isfinite(dec).all())
    assert (full.cpu() - host_full).abs().max().item() <= 2e-4
    assert (dec - full).abs().max().item() <= 2e-4


# Gradients: each kernel's autograd.Function against autograd through its
# plain version, at the reference tests' tolerances of max|g_plain|.
def _grads_vs_plain(fn, plain, inputs, grads_out, tol):
    leaves = [t.detach().requires_grad_() for t in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    assert all(o.grad_fn is not None for o in outs)
    got = torch.autograd.grad(outs, leaves, grads_out)
    plain_leaves = [t.detach().requires_grad_() for t in inputs]
    plain_outs = plain(*plain_leaves)
    plain_outs = plain_outs if isinstance(plain_outs, tuple) else (plain_outs,)
    want = torch.autograd.grad(plain_outs, plain_leaves, grads_out)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert (g.float() - w.float()).abs().max().item() <= tol * w.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dt,tol", [("f32", 2e-4), ("bf16", 2e-2)])
@pytest.mark.parametrize("shape,window", [((8, 300, 64), 0), ((4, 257, 128), 100),
                                          ((2, 130, 256), 0)])
def test_flash_attention_gradients_on_card(card, shape, window, dt, tol):
    gen = torch.Generator(device=card).manual_seed(1)
    q, k, v, g = (torch.randn(shape, generator=gen, device=card).to(TDT[dt]) for _ in range(4))
    _grads_vs_plain(lambda *x: flash_attention(*x, window=window),
                    lambda *x: tref.flash_attention_ref(*x, window=window), (q, k, v), (g,), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 300, 64), (3, 1000, 2560)])
def test_rglru_scan_gradients_on_card_run_the_kernel_backwards(card, shape):
    gen = torch.Generator(device=card).manual_seed(2)
    a = torch.rand(shape, generator=gen, device=card) ** 0.1
    b, g = (torch.randn(shape, generator=gen, device=card) for _ in range(2))
    launches, backward = rglru_scan.launches, rglru_scan.backward_launches
    _grads_vs_plain(rglru_scan, tref.rglru_scan_ref, (a, b), (g,), 1e-4)
    assert (rglru_scan.launches - launches, rglru_scan.backward_launches - backward) == (2, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 100, 2, 64), (2, 130, 4, 32)])
def test_wkv_gradients_on_card(card, shape):
    B, S, H, hd = shape
    gen = torch.Generator(device=card).manual_seed(3)
    r, k, v, g = (torch.randn(shape, generator=gen, device=card) for _ in range(4))
    logw = (-torch.exp(torch.rand(shape, generator=gen, device=card) * 22 - 20)).clamp(
        min=-math.e ** 2)
    u = 0.5 * torch.randn(H, hd, generator=gen, device=card)
    s0, gs = (torch.randn(B, H, hd, hd, generator=gen, device=card) for _ in range(2))
    _grads_vs_plain(wkv, tref.wkv_ref, (r, k, v, logw, u, s0), (g, gs), 2e-3)


# -- data parallel: the stacked mesh's DP step and the NCCL rank mesh --------


def _dp_tiny_cfg(dtype):
    import dataclasses

    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config("qwen1_5_0_5b")
    return dataclasses.replace(cfg, n_layers=2, d_model=128, n_heads=2, n_kv_heads=2,
                               head_dim=64, d_ff=256, vocab=256, param_dtype=dtype,
                               compute_dtype=dtype)


def _dp_fit(cfg, mesh, steps=3):
    from repro_torch.data import SyntheticLMSource
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    tcfg = TrainerConfig(compress_grads=True, dp_axis="data", adamw=AdamWConfig(lr=3e-3),
                         warmup=1, total_steps=10)
    tr = Trainer(cfg, tcfg, mesh=mesh)
    src = SyntheticLMSource(vocab=cfg.vocab, seq_len=64, global_batch=4, seed=0, branching=2)
    model, _ = tr.fit(src, steps=steps, seed=0)
    losses = [m["loss"] for m in tr.metrics_log if "loss" in m]
    return losses, {k: p.detach().clone() for k, p in model.named_parameters()}


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_stacked_dp_step_on_card_equals_the_plain_pmax(card, dt):
    """3 compressed DP steps over 4 stacked members: the reduce_nway pmax
    against the plain amax gives equal losses and parameters (the max is
    exact), and the kernel was launched once per reference leaf a step."""
    from unittest import mock

    from repro_torch.core import mesh as M

    cfg = _dp_tiny_cfg(TDT[dt])
    mesh = M.Mesh((4,), ("data",), device=card)
    before = reduce_nway.launches
    got = _dp_fit(cfg, mesh)
    assert reduce_nway.launches - before == 3 * 14
    with mock.patch.object(M, "reduce_nway", lambda x, op, dim: tref.reduce_nway_ref(x, op, dim)):
        want = _dp_fit(cfg, mesh)
    assert got[0] == want[0]
    assert all(torch.equal(p, want[1][k]) for k, p in got[1].items())


@pytest.mark.cuda
def test_rank_mesh_under_nccl_at_world_size_1_equals_the_stacked_mesh(card, tmp_path):
    """NCCL refuses two ranks on one card, so the card runs one: every axis
    function and 2 DP steps equal the stacked mesh of one member."""
    import torch.distributed as dist

    from repro_torch.core import mesh as M

    ranked = M.RankMesh((1,), ("data",), init_method=f"file://{tmp_path}/rendezvous", rank=0)
    try:
        assert dist.get_backend() == "nccl" and ranked.device.type == "cuda"
        stacked = M.Mesh((1,), ("data",), device=card)
        gen = torch.Generator(device=card).manual_seed(4)
        x = torch.randn(8, 16, generator=gen, device=card)
        for dtype in (torch.float32, torch.bfloat16, torch.float16, torch.float64, torch.int32):
            xd = (x * 2**20).to(dtype) if dtype == torch.int32 else x.to(dtype)
            fns = [lambda t: M.psum(t, "data"), lambda t: M.psum_scatter(t, "data"),
                   lambda t: M.all_gather(t, "data"), lambda t: M.ppermute(t, "data", [(0, 0)])]
            if dtype in (torch.float32, torch.bfloat16, torch.int32):  # the router's max
                fns.append(lambda t: M.pmax(t, "data"))
            for fn in fns:
                with ranked:
                    got = fn(xd)
                with stacked:
                    want = fn(xd[None])[0]
                assert got.dtype == want.dtype and torch.equal(got, want)
        cfg = _dp_tiny_cfg(torch.float32)
        got = _dp_fit(cfg, ranked, steps=2)
        want = _dp_fit(cfg, stacked, steps=2)
        assert got[0] == want[0]
        assert all(torch.equal(p, want[1][k]) for k, p in got[1].items())
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_sharded_trainer_on_nccl_at_world_size_1_is_bit_equal_to_the_stacked_mesh(card,
                                                                                  tmp_path):
    """2 steps of ``Trainer(policy=, mesh=)`` on a (1, 1) rank mesh under
    NCCL and on the stacked mesh of one member: equal losses and parameters,
    bit for bit (the stacked mesh's tied-embedding gradient lies transposed
    in memory; the global norm sums it in the logical order)."""
    import torch.distributed as dist

    from repro_torch.configs import get_smoke_config
    from repro_torch.core import mesh as M
    from repro_torch.data import SyntheticLMSource
    from repro_torch.launch.steps import make_policy
    from repro_torch.models import transformer as tt
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = get_smoke_config("qwen1_5_0_5b")
    src = SyntheticLMSource(vocab=cfg.vocab, seq_len=64, global_batch=2, seed=4)
    base = tt.init(torch.Generator(device=card).manual_seed(0), cfg, card)
    ranked = M.RankMesh((1, 1), ("data", "model"), init_method=f"file://{tmp_path}/rendezvous",
                        rank=0)
    try:
        runs = {}
        for kind, mesh in (("ranks", ranked),
                           ("stacked", M.Mesh((1, 1), ("data", "model"), device=card))):
            tr = Trainer(cfg, TrainerConfig(adamw=AdamWConfig(lr=1e-3), warmup=1,
                                            total_steps=10),
                         model=base, mesh=mesh, policy=make_policy(cfg, mesh))
            trained, _ = tr.fit(src, steps=2, seed=0)
            runs[kind] = ([m["loss"] for m in tr.metrics_log if "loss" in m],
                          {k: p.detach().clone() for k, p in trained.named_parameters()})
    finally:
        dist.destroy_process_group()
    (losses_r, params_r), (losses_s, params_s) = runs["ranks"], runs["stacked"]
    assert losses_r == losses_s
    for k, p in params_r.items():
        assert torch.equal(p, params_s[k].reshape(p.shape)), k


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["yi_6b", "moonshot_v1_16b"])
def test_sharded_smoke_prefill_on_a_stacked_mesh_on_card(card, arch):
    """A smoke model laid out on a stacked (1, 4) mesh on the card: its
    prefill through the kernels (flash, reduce_nway for every psum) against
    the same sharded prefill with plain attention, and the unsharded model
    (the MoE without drops: the expert-parallel capacity is per member)."""
    import dataclasses
    from unittest import mock

    from repro_torch.configs import get_smoke_config
    from repro_torch.core import mesh as M
    from repro_torch.launch.steps import make_policy
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import transformer as tt
    from repro_torch.models.convert import shard_model

    cfg = get_smoke_config(arch)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=64.0)
    model = tt.init(torch.Generator(device=card).manual_seed(0), cfg)
    tokens = torch.randint(0, cfg.vocab, (2, 16), generator=torch.Generator(device=card)
                           .manual_seed(1), device=card)
    want, _ = tt.prefill(model, tokens, cfg)
    mesh = M.Mesh((1, 4), ("data", "model"))
    policy = make_policy(cfg, mesh)
    shard_model(model, mesh, policy)
    flash, reduce = flash_attention.launches, reduce_nway.launches
    got, cache = tt.prefill(model, tokens, cfg, policy)
    torch.cuda.synchronize()
    assert flash_attention.launches == flash + cfg.n_layers
    assert reduce_nway.launches > reduce and cache.k.is_cuda and cache.k.shape[:2] == (1, 4)

    def plain(q, k, v, *, window=0, **_):
        return tref.flash_attention_ref(q, k, v, window=window)

    with mock.patch.object(attn_mod, "flash_attention", plain):
        plain_logits, _ = tt.prefill(model, tokens, cfg, policy)
    assert got.shape == (2, cfg.padded_vocab) and bool(torch.isfinite(got).all())
    assert (got - plain_logits).abs().max().item() <= 2e-4
    assert (got - want).abs().max().item() <= 2e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_reduce_nway_gradient_and_psum_backward_on_card(card, dt):
    """The kernel's sum carries a gradient (the cotangent broadcast), and the
    stacked mesh's psum runs the kernel again in its backward: both against
    autograd through the plain sum, the backward launches counted apart."""
    from repro_torch.core import mesh as M

    gen = torch.Generator(device=card).manual_seed(5)
    x = torch.randn(2, 4, 96, 64, generator=gen, device=card).to(TDT[dt]).requires_grad_()
    ct = torch.randn(2, 96, 64, generator=gen, device=card).to(TDT[dt])
    before = reduce_nway.launches
    y = reduce_nway(x, op="add", dim=1)
    assert y.grad_fn is not None and reduce_nway.launches == before + 1
    got, = torch.autograd.grad(y, x, ct)
    assert torch.equal(got, ct[:, None].expand_as(x))
    with M.Mesh((2, 4), ("data", "model"), device=card):
        y = M.psum(x, "model")
        ct = torch.randn(y.shape, generator=gen, device=card).to(TDT[dt])
        launches, back = reduce_nway.launches, reduce_nway.backward_launches
        got, = torch.autograd.grad(y, x, ct)
        torch.cuda.synchronize()
    assert reduce_nway.launches == launches + 1 and reduce_nway.backward_launches == back + 1
    want = tref.reduce_nway_ref(ct, "add", 1).unsqueeze(1).expand_as(ct)
    tol = 1e-6 if dt == "f32" else 2 ** -7
    assert ((got.float() - want.float()).abs() <= tol * (1 + want.float().abs())).all()


@pytest.mark.cuda
@pytest.mark.parametrize("seq_parallel", [False, True])
def test_sharded_step_gradients_on_card_equal_the_plain_run(card, seq_parallel):
    """qwen's smoke config on a stacked (2, 4) mesh on the card: the sharded
    loss's global gradients through the kernels (flash; reduce_nway for
    every psum, forward and backward) are non-zero and equal those with
    both kernels replaced by their plain versions, and the unsharded
    model's."""
    from unittest import mock

    from repro_torch.configs import get_smoke_config
    from repro_torch.core import mesh as M
    from repro_torch.launch.steps import make_policy
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import transformer as tt
    from repro_torch.models.convert import global_grads, reference_leaves, shard_model

    cfg = get_smoke_config("qwen1_5_0_5b")
    model = tt.init(torch.Generator(device=card).manual_seed(0), cfg, card, trainable=True)
    tokens = torch.randint(0, cfg.vocab, (4, 17), generator=torch.Generator(device=card)
                           .manual_seed(1), device=card)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    names = [n for n, _ in model.named_parameters()]
    unsharded = dict(zip(names, torch.autograd.grad(tt.loss_fn(model, batch, cfg),
                                                    list(model.parameters()))))
    mesh = M.Mesh((2, 4), ("data", "model"), device=card)
    policy = make_policy(cfg, mesh, seq_parallel=seq_parallel)
    shard_model(model, mesh, policy).requires_grad_(True)

    def grads():
        loss = tt.loss_fn(model, batch, cfg, policy)
        return global_grads(model, dict(zip(names, torch.autograd.grad(
            loss, list(model.parameters())))))

    launches, back = reduce_nway.launches, reduce_nway.backward_launches
    got = grads()
    torch.cuda.synchronize()
    assert reduce_nway.launches > launches and reduce_nway.backward_launches > back

    def plain_flash(q, k, v, *, window=0, **_):
        return tref.flash_attention_ref(q, k, v, window=window)

    with mock.patch.object(attn_mod, "flash_attention", plain_flash), \
            mock.patch.object(M, "reduce_nway", lambda x, op, dim: tref.reduce_nway_ref(x, op, dim)):
        plain = grads()
    want = {leaf: torch.stack([unsharded[n] for n in ns]) if "*" in leaf else unsharded[ns[0]]
            for leaf, ns in reference_leaves(unsharded, cfg).items()}
    for leaf, g in got.items():
        scale = want[leaf].abs().max().item()
        assert scale > 0 and g.abs().max().item() > 0, leaf
        assert (g - plain[leaf]).abs().max().item() <= 2e-4 * scale, leaf
        assert (g - want[leaf]).abs().max().item() <= 2e-4 * scale, leaf


@pytest.mark.cuda
@pytest.mark.parametrize("seq_parallel", [False, True], ids=["sp=False", "sp=True"])
@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "rwkv6_3b", "whisper_base"])
def test_sharded_family_smoke_prefill_on_card_matches_the_host(card, arch, seq_parallel):
    """A smoke model of the hybrid, rwkv6 or whisper laid out on a stacked
    (2, 4) mesh on the card, with sequence parallelism off and on: its
    sharded prefill through the kernels (``rglru_scan`` and flash, ``wkv``,
    or flash; ``reduce_nway`` for every psum) and a decode step after it
    against the same sharded run on the host (the plain versions)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import mesh as M
    from repro_torch.launch.steps import make_policy
    from repro_torch.models import get_family
    from repro_torch.models.convert import shard_model

    cfg = get_smoke_config(arch)
    fam = get_family(cfg)
    host = fam.init(torch.Generator().manual_seed(0), cfg, "cpu")
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (4, 17), generator=gen)
    frames = torch.randn(4, cfg.encoder_len, cfg.d_model, generator=gen)

    def run(device):
        model = copy.deepcopy(host).to(device)
        mesh = M.Mesh((2, 4), ("data", "model"), device=device)
        policy = make_policy(cfg, mesh, seq_parallel=seq_parallel)
        shard_model(model, mesh, policy)
        prompt = tokens[:, :16].to(device)
        if cfg.family == "whisper":
            prompt = {"frames": frames.to(device), "tokens": prompt}
        logits, cache = fam.prefill(model, prompt, cfg, policy, max_len=17)
        dec, _ = fam.decode_step(model, cache, tokens[:, 16:].to(device), 16, cfg, policy)
        return logits.cpu(), dec.cpu()

    counters = {"recurrentgemma_2b": [rglru_scan, flash_attention], "rwkv6_3b": [wkv],
                "whisper_base": [flash_attention]}[arch] + [reduce_nway]
    before = [c.launches for c in counters]
    got, got_dec = run(card)
    torch.cuda.synchronize()
    assert all(c.launches > b for c, b in zip(counters, before))
    want, want_dec = run("cpu")
    assert got.shape == (4, cfg.padded_vocab) and bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= 2e-4
    assert (got_dec - want_dec).abs().max().item() <= 2e-4


# -- the kernels as opaque ops (torch.ops.repro_torch.*) ---------------------------


def _op_cases(card):
    gen = torch.Generator(device=card).manual_seed(11)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=card).to(dtype)

    logw = -torch.rand(2, 130, 4, 32, generator=gen, device=card)
    return {
        "gemm": (lambda: gemm(rnd(2, 128, 64), rnd(2, 64, 96)), gemm,
                 2 * 2 * 128 * 96 * 64),
        "gemm_bf16": (lambda: gemm(rnd(2, 128, 64, dtype=torch.bfloat16),
                                   rnd(2, 64, 96, dtype=torch.bfloat16)), gemm,
                      2 * 2 * 128 * 96 * 64),
        "reduce_nway": (lambda: reduce_nway(rnd(5, 3, 1000), dim=0), reduce_nway, 4 * 3000),
        "flash_attention": (lambda: flash_attention(*(rnd(4, 200, 64, dtype=torch.bfloat16)
                                                      for _ in range(3)), window=50),
                            flash_attention, 4 * 64 * 4 * (50 * 51 // 2 + 150 * 50)),
        "rglru_scan": (lambda: rglru_scan(torch.rand(2, 300, 64, generator=gen, device=card),
                                          rnd(2, 300, 64)), rglru_scan, 2 * 2 * 300 * 64),
        "wkv": (lambda: wkv(rnd(2, 130, 4, 32), rnd(2, 130, 4, 32), rnd(2, 130, 4, 32), logw,
                            rnd(4, 32)), wkv, None),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gemm", "gemm_bf16", "reduce_nway", "flash_attention",
                                  "rglru_scan", "wkv"])
def test_kernel_ops_fake_implementations_and_flop_formulas_on_card(card, name):
    """A real launch: one launch counted, and FlopCounterMode counts the
    op's formula.  The same call under FakeTensorMode: the same output
    shapes and dtypes on the card's device, the same FLOPs, and nothing
    launched (the counter stays)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels.rwkv6 import wkv_flops

    call, wrapper, flops = _op_cases(card)[name]
    if flops is None:
        flops = wkv_flops(2, 130, 4, 32)
    before = wrapper.launches
    with FlopCounterMode(display=False) as real_flops:
        out = call()
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert real_flops.get_total_flops() == flops
    outs = out if isinstance(out, tuple) else (out,)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        with FlopCounterMode(display=False) as fake_flops:
            fake = call()
    fakes = fake if isinstance(fake, tuple) else (fake,)
    assert wrapper.launches == before + 1
    assert fake_flops.get_total_flops() == flops
    for f, o in zip(fakes, outs):
        assert (f.shape, f.dtype, f.device.type) == (o.shape, o.dtype, "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gemm", "reduce_nway", "flash_attention", "rglru_scan", "wkv"])
def test_a_run_launches_directly_and_a_trace_goes_through_the_op(card, name, monkeypatch):
    """On plain card tensors outside any dispatch mode the wrapper calls the
    op's CUDA implementation itself (one launch, the op's dispatcher entry
    untouched); under FlopCounterMode the call goes through the op."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import _build

    call, wrapper, _ = _op_cases(card)[name]
    seen = []
    real = _build.traced
    monkeypatch.setattr(_build, "traced", lambda *ts: seen.append(real(*ts)) or seen[-1])
    before = wrapper.launches
    call()
    assert seen == [False] and wrapper.launches == before + 1
    with FlopCounterMode(display=False):
        call()
    assert seen == [False, True] and wrapper.launches == before + 2
    x = torch.ones(3, 5, device=card)
    assert not real(x) and real(x.to("meta")) and real(x, torch.empty(1, device="meta"))
