"""The RG-LRU linear recurrence ``h_t = a_t h_{t-1} + b_t``.

Replaces ``src/repro/kernels/rglru.py:rglru_scan`` (``_rglru_kernel``).  The
kernel is ``csrc/rglru_scan.cu``, a single-pass scan with decoupled
look-back: every (batch row, tile of 8 channel vectors of 16 bytes,
segment of 128 steps) is a block of its own, in place of the TPU's
sequential chunk axis and its VMEM carry.  A block scans its segment,
publishes the segment's (prod a, h) pair with a flag, walks back over the
earlier segments' pairs until one has published its inclusive state, which
gives its incoming state, publishes its own, and writes h.  It is bound by
device-memory bytes: a and b read once and h written once (on an H100 SXM,
3 * B * S * W * itemsize over 3.35 TB/s).

The look-back's flags, pairs and ticket counters live in a scratch tensor
kept per (card, stream) between calls (:func:`_scratch`): each call takes
a new epoch, which its flags carry, so no flag is cleared per call, and
the kernel's last block sets the counters back to 0.

The numbers are the reference kernel's: the recurrence in f32 from
``h_{-1} = 0``, the output cast to ``a``'s dtype.  Steps past S are masked,
so S need not divide by any chunk: the reference's ``S % chunk == 0``
assert is not kept (serving pads each wave to its longest prompt), and
``chunk`` is accepted for its signature without changing the result.

Gradient: :class:`RglruScan`; its backward is the same kernel run over
reversed time.

Binding: the kernel is also the opaque op ``torch.ops.repro_torch.rglru_scan``
(``torch.library.custom_op``), whose CUDA implementation is the launch
that a run calls directly (``_build.traced``); a trace goes through the
op, whose fake implementation gives the output's shape, so a trace
under ``FakeTensorMode`` or on meta tensors (the dry run,
``launch/dryrun.py``) never reaches ``data_ptr()`` or the library, and
its FLOP formula (``torch.utils.flop_counter``) is the recurrence's
multiply and add, 2 * B * S * W.  ``rglru_scan.launches`` counts real
launches only.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rglru_scan_ref, wide

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (card index, stream) -> [scratch tensor, last epoch].  Shared by every
# caller on a stream: the stream orders their calls, and each call's epoch
# keeps the flags of the others apart.
_SCRATCH = {}


def _scratch(device, stream: int, words: int):
    """The look-back scratch for a call on ``stream``: (tensor, epoch).

    The tensor is zeroed once, when it is made or grown; each call takes
    the next epoch in [1, 2^30).
    """
    key = (device.index, stream)
    st = _SCRATCH.get(key)
    if st is None or st[0].numel() < words:
        st = _SCRATCH[key] = [torch.zeros(words, dtype=torch.int32, device=device), 0]
    st[1] = st[1] % ((1 << 30) - 1) + 1
    return st[0], st[1]


def rglru_scan(a, b, *, chunk: int = 128):
    """(B, S, W) a and b -> h (B, S, W) in a's dtype.

    a and b of mixed float dtypes are cast to float32 (exact from
    bfloat16), as the reference casts both to f32 on load.  A CPU tensor
    runs the plain version; a CUDA tensor launches the kernel or raises (a
    fake or meta tensor of a trace gets the output's shape from the op, and
    nothing launches).
    The output carries a gradient (:class:`RglruScan`).
    """
    del chunk  # the TPU's chunk; the CUDA kernel tiles itself
    if a.ndim != 3 or b.shape != a.shape:
        raise ValueError(f"rglru_scan: a {tuple(a.shape)}, b {tuple(b.shape)}; "
                         "need two equal (B, S, W)")
    if b.device != a.device:
        raise ValueError("rglru_scan: operands lie on different devices")
    if a.dtype not in DTYPES or b.dtype not in DTYPES:
        raise TypeError(f"rglru_scan: dtypes {a.dtype}, {b.dtype}; "
                        "need float32 or bfloat16 for both")
    if b.dtype != a.dtype:
        return rglru_scan(a.float(), b.float()).to(a.dtype)
    if a.device.type != "cpu" and not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("rglru_scan: operands must be contiguous")
    return RglruScan.apply(a, b)


def _scan(a, b):
    """The plain version on the CPU; on the card, the kernel (its op under a
    trace)."""
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b)
    return (torch.ops.repro_torch.rglru_scan if _build.traced(a, b) else _launch)(a, b)


def _launch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The launch on the card."""
    B, S, W = a.shape
    out = torch.empty_like(a)
    dtype = DTYPES[a.dtype]
    with torch.cuda.device(a.device):
        lib = _build.library()
        stream = torch.cuda.current_stream().cuda_stream
        buf, epoch = _scratch(a.device, stream, lib.repro_rglru_scan_scratch(dtype, B, S, W))
        rc = lib.repro_rglru_scan(a.data_ptr(), b.data_ptr(), out.data_ptr(), dtype, B, S, W,
                                  buf.data_ptr(), buf.numel(), epoch, stream)
    _build.check(rc, "rglru_scan")
    rglru_scan.launches += 1
    return out


_scan_op = torch.library.custom_op("repro_torch::rglru_scan", mutates_args=(),
                                   device_types="cuda")(_launch)


@_scan_op.register_fake
def _(a, b):
    return torch.empty_like(a)


@register_flop_formula(torch.ops.repro_torch.rglru_scan)
def rglru_scan_flops(a_shape, b_shape=None, *, out_shape=None, **_) -> int:
    """2 * B * S * W: h_t = a_t h_{t-1} + b_t, one multiply and one add."""
    B, S, W = a_shape
    return 2 * B * S * W


class RglruScan(torch.autograd.Function):
    """The scan with its adjoint, which is the same scan run backwards.

    With g the gradient of h, g'_t = g_t + a_{t+1} g'_{t+1}, db_t = g'_t and
    da_t = g'_t h_{t-1} (h_{-1} = 0): g' is the scan of (a shifted left by
    one, 0 at the end; g) over reversed time, in f32, so the backward
    launches the kernel once more on the card (:func:`rglru_scan_grad`).
    It saves a and h; a and b share one dtype.
    """

    @staticmethod
    def forward(ctx, a, b):
        h = _scan(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        return rglru_scan_grad(a, h, g)


def rglru_scan_grad(a, h, g):
    """(da, db) of h = rglru_scan(a, b) against h's gradient ``g``, in a's dtype."""
    a32 = wide(a)
    a_next = torch.cat([a32[:, 1:], torch.zeros_like(a32[:, :1])], dim=1)
    before = rglru_scan.launches
    gp = _scan(a_next.flip(1), wide(g).flip(1)).flip(1)
    rglru_scan.backward_launches += rglru_scan.launches - before
    h_prev = torch.cat([torch.zeros_like(gp[:, :1]), wide(h)[:, :-1]], dim=1)
    return (gp * h_prev).to(a.dtype), gp.to(a.dtype)


rglru_scan.launches = 0           # every launch
rglru_scan.backward_launches = 0  # those of the backward (:func:`rglru_scan_grad`)
