"""glm4-9b [dense] — 40L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=151552, RoPE + GQA.  [hf:THUDM/glm-4-9b]"""

from repro_torch.configs._util import reduce_for_smoke
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="transformer",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=151552,
)


def smoke_config():
    return reduce_for_smoke(CONFIG, n_kv_heads=1)
