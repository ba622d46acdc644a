"""The inputs that the benchmark makes from the seed and hands to both the
program and the reference: a dense transformer's weights, drawn on the
device in one call a kind of weight, and the token stream.  Torch and
numpy only; nothing of the program."""

from __future__ import annotations

import numpy as np


def widths(cfg: dict) -> dict:
    """The widths of a dense GQA transformer from its published keys."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    hd = cfg.get("head_dim") or d // h
    return {"d": d, "f": cfg["intermediate_size"], "h": h, "kv": cfg["num_key_value_heads"],
            "hd": hd, "L": cfg["num_hidden_layers"], "V": cfg["vocab_size"]}


def llama_weights(cfg: dict, seed: int, device, dtype, generator=None) -> dict:
    """Every weight by the program's parameter name, drawn from a generator
    on ``device`` seeded with ``seed`` (or from ``generator``, which goes on
    to draw what follows), one draw a kind of weight (stacked
    over the layers), in ``dtype``: products N(0, 1 / fan_in), the embedding
    and the head N(0, 0.02^2), the norm scales zero (they scale by 1 +
    scale).  The layers' tensors are views of the stacked draws."""
    import torch

    w = widths(cfg)
    d, f, L, V = w["d"], w["f"], w["L"], w["V"]
    gen = generator or torch.Generator(device=device).manual_seed(seed % (1 << 63))

    def draw(shape, std):
        return torch.randn(shape, generator=gen, device=device).mul_(std).to(dtype)

    out = {"embed": draw((V, d), 0.02)}
    stacked = {
        "attn.wq": draw((L, d, w["h"] * w["hd"]), d ** -0.5),
        "attn.wk": draw((L, d, w["kv"] * w["hd"]), d ** -0.5),
        "attn.wv": draw((L, d, w["kv"] * w["hd"]), d ** -0.5),
        "attn.wo": draw((L, w["h"] * w["hd"], d), (w["h"] * w["hd"]) ** -0.5),
        "mlp.w_gate": draw((L, d, f), d ** -0.5),
        "mlp.w_up": draw((L, d, f), d ** -0.5),
        "mlp.w_down": draw((L, f, d), f ** -0.5),
        "norm1": torch.zeros((L, d), dtype=dtype, device=device),
        "norm2": torch.zeros((L, d), dtype=dtype, device=device),
    }
    for key, t in stacked.items():
        for i in range(L):
            out[f"blocks.{i}.{key}"] = t[i]
    out["final_norm"] = torch.zeros((d,), dtype=dtype, device=device)
    out["lm_head"] = draw((V, d), 0.02)
    return out


def token_batch(seed: int, step: int, batch: int, seq: int, vocab: int) -> dict:
    """Step ``step``'s rows: ``batch`` sequences of ``seq`` tokens drawn
    uniformly from the vocabulary, with their next tokens as labels; every
    step's rows differ, and one seed gives the same stream."""
    rng = np.random.default_rng([seed % (1 << 63), step])
    x = rng.integers(0, vocab, size=(batch, seq + 1), dtype=np.int64)
    return {"tokens": np.ascontiguousarray(x[:, :-1]), "labels": np.ascontiguousarray(x[:, 1:])}
