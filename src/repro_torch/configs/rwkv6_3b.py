"""rwkv6-3b "Finch" [ssm] — 32L d_model=2560 (attention-free) d_ff=8960
vocab=65536, data-dependent decay, head size 64.  [arXiv:2404.05892]"""

from repro_torch.configs._util import reduce_for_smoke
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="rwkv6",
    n_layers=32,
    d_model=2560,
    n_heads=40,            # = d_model / rwkv_head_size
    n_kv_heads=40,
    d_ff=8960,
    vocab=65536,
    rwkv_head_size=64,
)


def smoke_config():
    return reduce_for_smoke(CONFIG, n_heads=4, n_kv_heads=4)
