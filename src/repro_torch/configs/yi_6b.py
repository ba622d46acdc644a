"""yi-6b [dense] — 32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000,
llama-arch GQA.  [arXiv:2403.04652]"""

from repro_torch.configs._util import reduce_for_smoke
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="transformer",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab=64000,
    rope_theta=5_000_000.0,
)


def smoke_config():
    return reduce_for_smoke(CONFIG, n_kv_heads=1)
