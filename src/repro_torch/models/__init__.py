"""The model zoo in PyTorch: the dense decoder-only transformers, the
RG-LRU / local-attention hybrid (recurrentgemma) and RWKV-6 so far.

``get_family(cfg)`` returns the family's module, which exposes
``init(gen, cfg, device, trainable=False)``, ``forward``, ``loss_fn``,
``prefill`` and ``decode_step`` (see ``models.api``).
``models.convert.from_jax_params`` carries the JAX reference's parameters
across.
"""

from repro_torch.models.api import get_family  # noqa: F401
