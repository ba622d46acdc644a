"""Optimizers of the port: AdamW, int8 gradient compression, LR schedules
(``repro.optim``)."""

from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update, global_norm,  # noqa: F401
                                    opt_state_specs)
from repro_torch.optim.compress import compress_int8, compressed_mean, decompress_int8  # noqa: F401
from repro_torch.optim.schedule import warmup_cosine  # noqa: F401
