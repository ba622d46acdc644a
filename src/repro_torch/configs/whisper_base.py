"""whisper-base [audio] — 6L enc + 6L dec, d_model=512 8H d_ff=2048
vocab=51865, conv frontend stubbed (precomputed frame embeddings).
[arXiv:2212.04356]"""

from repro_torch.configs._util import reduce_for_smoke
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="whisper",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    encoder_layers=6,
    encoder_len=1500,
)


def smoke_config():
    return reduce_for_smoke(CONFIG, n_kv_heads=4)
