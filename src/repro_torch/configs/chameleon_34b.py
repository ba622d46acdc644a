"""chameleon-34b [vlm] — 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536 (unified text + VQ image tokens, early fusion).
The VQ-GAN image tokenizer is a stub: inputs are token ids in the fused
vocab (input_specs() provides them precomputed).  [arXiv:2405.09818]"""

from repro_torch.configs._util import reduce_for_smoke
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="transformer",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=65536,
)


def smoke_config():
    return reduce_for_smoke(CONFIG)
