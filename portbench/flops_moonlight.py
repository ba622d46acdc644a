"""The yardstick's arithmetic for Moonlight-16B-A3B (DeepSeek-V3's
architecture): the model FLOPs of a training step and MLA attention's
FLOPs, counted from the configuration's published widths.

A token's forward takes 2 FLOPs per product weight it meets: every layer's
MLA projections (``wq``, ``wkv_a``, ``wkv_b``, ``wo``), the dense layers'
MLP, each MoE layer's router, its ``num_experts_per_tok`` routed experts
and its shared experts, and the head (the embedding is a lookup).  MLA's
attention takes 2 (qk + v) FLOPs per live causal pair per head, qk =
``qk_nope_head_dim + qk_rope_head_dim``: Q K^T at qk and P V at v, the
unpadded (192, 128) work.  Capacity drops are not subtracted: the model's
FLOPs are those of every routed pair.
"""

from __future__ import annotations

from portbench.flops import causal_pairs


def active_weights(cfg: dict) -> int:
    """Product weights a token meets in one forward."""
    d, H, L = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_hidden_layers"]
    nope, rope, vd, r = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                         cfg["kv_lora_rank"])
    mla = d * H * (nope + rope) + d * (r + rope) + r * H * (nope + vd) + H * vd * d
    dense = 3 * d * cfg["intermediate_size"]
    fe = cfg["moe_intermediate_size"]
    moe = (d * cfg["n_routed_experts"] + cfg["num_experts_per_tok"] * 3 * d * fe
           + 3 * d * fe * cfg["n_shared_experts"])
    k = cfg["first_k_dense_replace"]
    return L * mla + k * dense + (L - k) * moe + cfg["vocab_size"] * d


def attention_flops(cfg: dict, batch: int, seq: int) -> float:
    """One forward's MLA attention: 2 (qk + v) per live causal pair per head."""
    per_pair = 2 * (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"] + cfg["v_head_dim"])
    return (float(per_pair) * cfg["num_attention_heads"] * batch * causal_pairs(seq)
            * cfg["num_hidden_layers"])


def train_flops(cfg: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: 3 x the forward; the remat
    recompute is not counted."""
    return 3.0 * (2.0 * batch * seq * active_weights(cfg) + attention_flops(cfg, batch, seq))
