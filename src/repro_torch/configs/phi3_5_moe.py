"""phi3.5-moe-42b-a6.6b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, MoE 16 experts top-2.  [hf:microsoft/Phi-3.5-MoE-instruct]"""

from repro_torch.configs._util import reduce_for_smoke
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="transformer",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab=32064,
    n_experts=16,
    top_k=2,
)


def smoke_config():
    return reduce_for_smoke(CONFIG)
