"""moonlight-16b-a3b [moe, mla] — 27L d_model=2048 16H, MLA (no q compression,
kv_lora_rank 512, qk 128 + 64 rope, v 128), layer 0 a dense MLP of 11264,
then DeepSeek-V3 MoE: 64 routed experts of 1408, top-6 by sigmoid score
plus a selection bias, gates normalised and times 2.446, 2 shared experts;
vocab=163840, rope_theta 50000, rms eps 1e-5, untied head.
[hf:moonshotai/Moonlight-16B-A3B/config.json]

The port's own architecture (the JAX package has no MLA and no
DeepSeek-V3 router), so it is not in ``ARCH_IDS``; ``get_config`` finds it
by name.  The sequence-wise balance loss at 1e-4 and the bias rate 0.001
are DeepSeek-V3's (arXiv:2412.19437 §4.2); the published config has
neither."""

import dataclasses

from repro_torch.configs._util import reduce_for_smoke
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="moonlight-16b-a3b",
    family="transformer",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=11264,
    vocab=163840,
    rope_theta=50_000.0,
    norm_eps=1e-5,
    n_experts=64,
    top_k=6,
    moe_d_ff=1408,
    n_shared_experts=2,
    router_scoring="sigmoid",
    router_bias_rate=0.001,
    routed_scaling=2.446,
    aux_loss_coef=1e-4,
    first_k_dense=1,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
)


def smoke_config():
    """3 layers (the dense one and two MoE), every width cut, 8 experts top-3."""
    return reduce_for_smoke(CONFIG, n_layers=3, n_kv_heads=4, n_experts=8, top_k=3,
                            moe_d_ff=32, kv_lora_rank=32, qk_nope_head_dim=16,
                            qk_rope_head_dim=8, v_head_dim=16, aux_loss_coef=0.01)


def from_published(cfg: dict, **overrides) -> ModelConfig:
    """The config of a deepseek_v3 ``config.json``'s keys (``q_lora_rank``
    null, one group, sigmoid scores), with the keys that it lacks:
    ``aux_loss_alpha``, ``bias_update_speed`` and ``capacity_factor``."""
    if cfg.get("q_lora_rank") is not None or cfg.get("n_group", 1) != 1:
        raise NotImplementedError("query compression and group-limited routing are not ported")
    return dataclasses.replace(
        CONFIG, n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"], n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"], rope_theta=cfg["rope_theta"],
        norm_eps=cfg["rms_norm_eps"], tie_embeddings=cfg["tie_word_embeddings"],
        n_experts=cfg["n_routed_experts"], top_k=cfg["num_experts_per_tok"],
        moe_d_ff=cfg["moe_intermediate_size"], n_shared_experts=cfg["n_shared_experts"],
        routed_scaling=cfg["routed_scaling_factor"], first_k_dense=cfg["first_k_dense_replace"],
        kv_lora_rank=cfg["kv_lora_rank"], qk_nope_head_dim=cfg["qk_nope_head_dim"],
        qk_rope_head_dim=cfg["qk_rope_head_dim"], v_head_dim=cfg["v_head_dim"],
        aux_loss_coef=cfg["aux_loss_alpha"], router_bias_rate=cfg["bias_update_speed"],
        capacity_factor=cfg["capacity_factor"], **overrides)
