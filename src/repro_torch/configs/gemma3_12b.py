"""gemma3-12b [dense] — 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144, 5:1 local:global sliding window (1024), 128k context.
[hf:google/gemma-3 family]"""

from repro_torch.configs._util import reduce_for_smoke
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="transformer",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab=262144,
    attn_window=1024,
    local_global_ratio=5,
    tie_embeddings=True,
)


def smoke_config():
    return reduce_for_smoke(CONFIG, n_layers=6, local_global_ratio=2)
