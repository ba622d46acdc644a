"""moonshot-v1-16b-a3b [moe] — 48L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=163840, MoE 64 experts top-6 (kimi/moonlight).
[hf:moonshotai/Moonlight-16B-A3B]"""

from repro_torch.configs._util import reduce_for_smoke
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="transformer",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=163840,
    n_experts=64,
    top_k=6,
)


def smoke_config():
    return reduce_for_smoke(CONFIG, n_experts=8, top_k=3)
