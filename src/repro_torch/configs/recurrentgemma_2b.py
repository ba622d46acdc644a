"""recurrentgemma-2b [hybrid] — 26L d_model=2560 10H (MQA kv=1) d_ff=7680,
RG-LRU + local attention, pattern (rec, rec, attn), window 2048.
[arXiv:2402.19427]"""

from repro_torch.configs._util import reduce_for_smoke
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="rglru_hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab=256000,
    attn_window=2048,
    block_pattern=("rec", "rec", "attn"),
    lru_width=2560,
    tie_embeddings=True,
)


def smoke_config():
    return reduce_for_smoke(CONFIG, n_heads=2, n_kv_heads=1, head_dim=32)
