"""Shared building blocks: the model config, norms and initialisers.

The port's counterpart of ``src/repro/models/common.py``.  ``ModelConfig``
has the reference's fields, with torch dtypes.  ``remat`` recomputes each
layer in the backward pass (:func:`maybe_remat`, ``torch.utils.checkpoint``
in place of ``jax.checkpoint``); the JAX-only knob ``scan_layers`` is
accepted and changes nothing (the port runs its layers in a Python loop);
``attn_q_chunk`` only bounds memory in the reference, and the flash kernel
already works in blocks, so it is ignored too.  ``attn_bf16_logits`` is
the reference's: attention logits, their scale, mask and softmax in bf16
(``models/attention.py``); causal self-attention then takes the plain
bf16-logit path in place of the flash kernel, which softmaxes in f32.
``ShardingPolicy`` and ``REPLICATED`` are the reference's, with a spec as
the plain tuple that ``core.mesh.shard`` / ``unshard`` take (an entry is
``None``, an axis name or a tuple of names) in place of ``PartitionSpec``.
The reference's ``constrain`` is not copied: it changes a layout and
never a number, and the port's sharded bodies lay their tensors out
explicitly (``models/parallel.py``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core import mesh as M


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One record per assigned architecture (see ``repro_torch.configs``)."""

    name: str
    family: str                    # transformer | rglru_hybrid | rwkv6 | whisper
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: int = 0              # 0 -> d_model // n_heads
    # attention pattern
    attn_window: int = 0           # 0 -> full attention; >0 -> sliding window
    local_global_ratio: int = 0    # gemma3: N local layers per 1 global
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # hybrid (recurrentgemma): pattern of blocks, e.g. ("rec", "rec", "attn")
    block_pattern: tuple[str, ...] = ()
    lru_width: int = 0             # 0 -> d_model
    conv_width: int = 4
    # rwkv
    rwkv_head_size: int = 64
    # whisper
    encoder_layers: int = 0
    encoder_len: int = 1500
    # memory-only in the reference; ignored here (the kernel is blockwise)
    attn_q_chunk: int = 0
    # attention logits and softmax in bf16 (the plain path, not the kernel)
    attn_bf16_logits: bool = False
    moe_token_shard: bool = True
    # numerics
    param_dtype: Any = torch.bfloat16
    compute_dtype: Any = torch.bfloat16
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # loss
    loss_chunk: int = 1024
    remat: bool = True             # recompute each layer in the backward pass
    scan_layers: bool = True       # JAX-only; no effect

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(1, self.n_kv_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256, as the reference pads it."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def n_params(self) -> int:
        """Approximate parameter count, by the reference's formula."""
        d, f, L, v = self.d_model, self.d_ff, self.n_layers, self.padded_vocab
        hd = self.head_dim
        if self.family == "rwkv6":
            per_layer = 4 * d * d + d * d + 2 * d * f + 6 * d * 32 * 2
        elif self.family == "rglru_hybrid":
            rec = 2 * d * (self.lru_width or d) + (self.lru_width or d) * d
            attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (self.n_heads * hd) * d
            mlp = 3 * d * f
            n_attn = sum(1 for i in range(L) if self._block_kind(i) == "attn")
            return (L - n_attn) * (rec + mlp) + n_attn * (attn + mlp) + 2 * v * d
        else:
            attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (self.n_heads * hd) * d
            if self.n_experts:
                mlp = self.n_experts * 3 * d * f + d * self.n_experts
            else:
                mlp = 3 * d * f
            per_layer = attn + mlp
        total = L * per_layer + 2 * v * d
        if self.family == "whisper":
            total += self.encoder_layers * (2 * attn + 2 * d * f + d * f)
        return total

    @property
    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k experts only)."""
        if not self.n_experts:
            return self.n_params
        d, f, L = self.d_model, self.d_ff, self.n_layers
        hd = self.head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (self.n_heads * hd) * d
        mlp = self.top_k * 3 * d * f + d * self.n_experts
        return L * (attn + mlp) + 2 * self.padded_vocab * d

    def _block_kind(self, i: int) -> str:
        if not self.block_pattern:
            return "attn"
        return self.block_pattern[i % len(self.block_pattern)]


# ---------------------------------------------------------------------------
# Sharding policy
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """Maps logical tensor dimensions to mesh axes.

    ``batch_axes`` collect DP axes (('pod','data') on the multi-pod mesh);
    ``model_axis`` is the TP/EP axis.  ``divisible`` guards: a dimension is
    only sharded if the axis size divides it (e.g. 4 KV heads or 8 whisper
    heads do NOT shard over a 16-wide model axis -> replicate).
    """

    batch_axes: tuple[str, ...] = ("data",)
    model_axis: Optional[str] = "model"
    mesh_axis_sizes: dict[str, int] = dataclasses.field(default_factory=dict)
    # Sequence parallelism (Megatron-style): between blocks, activations are
    # sharded on the sequence dim over ``seq_axis``.
    seq_axis: Optional[str] = None
    # Decode-path layout hint of the reference (in-flight q/k/v follow the
    # KV-cache layout).  The port's decode always does, so no model path
    # reads it; it is kept for the dry-run tooling (ROADMAP.md), whose
    # reference steps and hill-climb set it through ``make_policy``.
    align_decode_cache: bool = False
    # The port's own: the KV cache's sequence dim laid out over this axis
    # (the long-context decode cell, where the reference's
    # ``launch/steps.py:cache_specs`` lays the cache out so and GSPMD does
    # the rest): each member attends over its block of the cache, and the
    # blocks merge by their log-sum-exp (``models/attention.py``).
    cache_seq_axis: Optional[str] = None

    def kv_dims(self, n_kv: int, head_dim: int):
        """(kv_spec, hd_spec) for cache dims: prefer kv heads, else head_dim."""
        kv = self._model_if_divisible(n_kv)
        if kv is not None:
            return kv, None
        return None, self._model_if_divisible(head_dim)

    def _model_if_divisible(self, dim: int):
        if self.model_axis is None:
            return None
        size = self.mesh_axis_sizes.get(self.model_axis, 1)
        return self.model_axis if dim % size == 0 else None

    # -- parameter specs --
    def w_col(self, out_dim: int) -> tuple:     # (d_in, d_out) column parallel
        return (None, self._model_if_divisible(out_dim))

    def w_row(self, in_dim: int) -> tuple:      # (d_in, d_out) row parallel
        return (self._model_if_divisible(in_dim), None)

    def w_expert_col(self, n_experts: int, out_dim: int) -> tuple:
        e = self._model_if_divisible(n_experts)
        return (e, None, None if e else self._model_if_divisible(out_dim))

    def w_expert_row(self, n_experts: int, in_dim: int) -> tuple:
        e = self._model_if_divisible(n_experts)
        return (e, None if e else self._model_if_divisible(in_dim), None)

    def embed(self, vocab: int) -> tuple:
        return (self._model_if_divisible(vocab), None)

    def none(self) -> tuple:
        return ()

    # -- activation specs --
    def act_bsd(self) -> tuple:                 # (batch, seq, d)
        return (self.batch_axes or None, self.seq_axis, None)

    def act_bshd(self, n_heads: int) -> tuple:  # (batch, seq, heads, head_dim)
        return (self.batch_axes or None, None, self._model_if_divisible(n_heads), None)

    def act_bsf(self, d_ff: int) -> tuple:      # (batch, seq, d_ff)
        return (self.batch_axes or None, None, self._model_if_divisible(d_ff))

    def act_bsv(self, vocab: int) -> tuple:     # (batch, seq, vocab)
        return (self.batch_axes or None, None, self._model_if_divisible(vocab))

    def kv_cache(self, n_kv: int) -> tuple:     # (layers, batch, seq, kv, hd)
        return (None, self.batch_axes or None, None, self._model_if_divisible(n_kv), None)


REPLICATED = ShardingPolicy(batch_axes=(), model_axis=None)


def rms_norm(x, scale, eps: float = 1e-6):
    """RMS norm scaled by ``1 + scale`` (the scales are initialised to zero)."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    """LayerNorm in f32 (whisper): ``(x - mean) / sqrt(var + eps) * scale +
    bias``, scaled by ``scale`` itself (the scales are initialised to one)."""
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps) * scale + bias
    return out.to(dtype)


def param(t: torch.Tensor) -> nn.Parameter:
    """A parameter, frozen until its model is built with ``trainable=True``
    (the families' ``init`` and ``convert.from_jax_params``), which calls
    ``requires_grad_`` on the whole model: serving keeps frozen weights."""
    return nn.Parameter(t, requires_grad=False)


def dense_init(gen: torch.Generator, shape, dtype, device=None, scale: float | None = None):
    """Normal weights with std ``scale / sqrt(fan_in)``, drawn from ``gen``."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = (scale if scale is not None else 1.0) / math.sqrt(fan_in)
    w = torch.randn(shape, generator=gen, device=device or gen.device)
    return (w * std).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype, device=None):
    w = torch.randn((vocab, d), generator=gen, device=device or gen.device)
    return (w * 0.02).to(dtype)


def resolve_device(device) -> torch.device:
    """``None`` means CUDA, and raises without a card; the CPU only when asked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device='cpu' to run the plain "
                               "versions on the host")
        device = "cuda"
    return torch.device(device)


def chunked_cross_entropy(hidden, head, labels, cfg: ModelConfig, mb=None):
    """Mean next-token cross-entropy without the full (B, S, V) logits.

    The counterpart of ``src/repro/models/common.py:chunked_cross_entropy``:
    the sequence is cut into ``cfg.loss_chunk`` slabs (the last one ragged);
    each slab's logits are ``hidden @ head^T`` in f32, its loss is
    ``logsumexp - gold`` over labels ``>= 0`` (negative labels are ignored),
    and the result is ``total / max(count, 1)``.  Each slab runs under
    ``torch.utils.checkpoint``, so one (B, chunk, V) slab of logits is alive
    at a time in the backward pass as in the forward.

    Under a sharding policy (``mb``, the ``models.parallel.Members`` of the
    current mesh) ``hidden`` (*lead, B, S, d) and ``labels`` (*lead, B, S)
    are the member's rows, and ``head`` (*lead, V / tp, d) its block of the
    vocab where the spec splits it: the log-sum-exp over the padded vocab is
    ``max + log psum(sum exp(logits - max))`` with the row max a ``pmax``
    (detached: the shift carries no gradient, as in ``jax.nn.logsumexp``),
    the gold logit comes from the member whose block holds the label
    (``psum``), and the total and count are ``psum``'d over the batch axes.
    A slab's recompute runs the same collectives in the same order on every
    member.  Returns the global loss, one value a member (*lead).
    """
    S = hidden.shape[-2]
    chunk = min(cfg.loss_chunk, S)
    lead = hidden.shape[:-3]
    total = torch.zeros(lead, dtype=torch.float32, device=hidden.device)
    count = torch.zeros(lead, dtype=torch.float32, device=hidden.device)
    slab = _chunk_loss if mb is None else functools.partial(
        _chunk_loss_tp, mb=mb, split=mb.split(mb.policy.embed(cfg.padded_vocab)))
    for s0 in range(0, S, chunk):
        h, y = hidden[..., s0:s0 + chunk, :], labels[..., s0:s0 + chunk]
        if torch.is_grad_enabled():
            loss, n = checkpoint(slab, h, head, y, use_reentrant=False)
        else:
            loss, n = slab(h, head, y)
        total, count = total + loss, count + n
    if mb is not None:
        for axis in mb.batch:
            total, count = M.psum(total, axis), M.psum(count, axis)
    return total / torch.clamp(count, min=1.0)


def _chunk_loss(h, head, y):
    logits = h.float() @ head.float().T
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y.clamp(min=0)[..., None].long())[..., 0]
    valid = (y >= 0).float()
    return torch.sum((logz - gold) * valid), torch.sum(valid)


def _chunk_loss_tp(h, head, y, mb, split: bool):
    """One slab on the member's rows: (total, count), each (*lead).  It
    enters the mesh itself, since its recompute runs in the backward pass."""
    logits = mb.mm(h.float(), head.float().transpose(-1, -2))  # (*lead, B, chunk, V / tp)
    if split:
        with mb.mesh:
            V = logits.shape[-1]
            shift = M.pmax(logits.detach().amax(-1), mb.axis)
            logz = shift + torch.log(mb.psum(torch.exp(logits - shift[..., None]).sum(-1)))
            local = y - M.lift(mb.index(), y) * V
            mine = (local >= 0) & (local < V)
            gold = torch.gather(logits, -1, local.clamp(0, V - 1)[..., None].long())[..., 0]
            gold = mb.psum(torch.where(mine, gold, 0.0))
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, y.clamp(min=0)[..., None].long())[..., 0]
    valid = (y >= 0).float()
    return torch.sum((logz - gold) * valid, (-2, -1)), torch.sum(valid, (-2, -1))


def maybe_remat(fn, enabled: bool):
    """``fn`` recomputed in the backward pass when ``enabled`` and autograd
    records (``jax.checkpoint`` in the reference); ``fn`` itself otherwise."""
    if not enabled:
        return fn

    def remat(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False)

    return remat
