"""The yardstick's arithmetic: the H100's published peaks, and the
operations and bytes that a cell's work needs, counted from its shapes.

Copied, not imported, from ``chip_smoke.py`` (``PEAK_*``, ``bound``,
``product_bounds``, ``train_flops``) so that a change to the program
cannot move the yardstick.  ``train_flops`` here is computed from the
configuration's widths and counts the untied head once.
"""

from __future__ import annotations

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W).
PEAK_F32 = 67e12        # FLOP/s, CUDA cores
PEAK_TF32 = 494.7e12    # FLOP/s, tensor cores, TF32
PEAK_BF16 = 989e12      # FLOP/s, tensor cores
PEAK_BYTES = 3.35e12    # HBM bytes/s
# f32 products at f32 accuracy: the larger of the CUDA-core rate and three
# TF32 products (3xTF32) at the tensor-core rate.
PEAK_F32_ACCURATE = max(PEAK_F32, PEAK_TF32 / 3)


def bound_s(ops: float, rate: float, nbytes: float) -> tuple[float, str]:
    """The least time of ``ops`` operations at ``rate`` and ``nbytes`` moved at
    the HBM rate, in seconds, and which of the two bounds it."""
    t_ops, t_bytes = ops / rate, nbytes / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def product_bound_s(ops: float, nbytes: float, dtype: str) -> float:
    """A product's least time: bf16 at the bf16 tensor-core rate, f32 at
    ``PEAK_F32_ACCURATE``."""
    rate = PEAK_BF16 if dtype == "bfloat16" else PEAK_F32_ACCURATE
    return bound_s(ops, rate, nbytes)[0]


def gemm_flops(m: int, k: int, n: int) -> float:
    """``C = A @ B`` with A (m, k) and B (k, n)."""
    return 2.0 * m * k * n


def gemm_bytes(m: int, k: int, n: int, itemsize: int) -> float:
    """Each operand read once and the result written once."""
    return float(itemsize * (m * k + k * n + m * n))


def reduce_bytes(n: int, elements: int, itemsize: int) -> float:
    """An n-way sum of ``elements`` each: n inputs read, one result written."""
    return float(itemsize * elements * (n + 1))


def causal_pairs(s: int, window: int = 0) -> int:
    """Live (query, key) pairs of a causal mask over s, within ``window`` when > 0."""
    if window <= 0 or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def dense_weights(cfg: dict) -> int:
    """The product weights of a dense GQA transformer with a gated MLP and an
    untied head, from the configuration's published keys: every layer's
    q, k, v, o and three MLP matrices, and the head (the embedding is a
    lookup, not a product)."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or d // h
    layer = d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * f
    return cfg["num_hidden_layers"] * layer + cfg["vocab_size"] * d


def attention_flops(cfg: dict, batch: int, seq: int) -> float:
    """One forward's attention: 4 * head_dim per live causal pair per head."""
    h = cfg["num_attention_heads"]
    hd = cfg.get("head_dim") or cfg["hidden_size"] // h
    return 4.0 * hd * h * batch * causal_pairs(seq) * cfg["num_hidden_layers"]


def train_flops(cfg: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: 3 x the forward, whose products
    take 2 per weight per token (the head included) and whose attention
    takes ``attention_flops``; the remat recompute is not counted."""
    return 3.0 * (2.0 * batch * seq * dense_weights(cfg) + attention_flops(cfg, batch, seq))
