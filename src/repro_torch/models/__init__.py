"""The model zoo in PyTorch: the dense and MoE decoder-only transformers,
the RG-LRU / local-attention hybrid (recurrentgemma), RWKV-6 and the
whisper encoder-decoder, every family of the reference.

``get_family(cfg)`` returns the family's module, which exposes
``init(gen, cfg, device, trainable=False)``, ``loss_fn``, ``prefill`` and
``decode_step`` (and ``forward``, but for whisper, whose passes are
``encode`` and ``_decoder``; see ``models.api``).
``models.convert.from_jax_params`` carries the JAX reference's parameters
across.
"""

from repro_torch.models.api import get_family  # noqa: F401
