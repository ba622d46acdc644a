"""Deterministic data sources of the port: a copy of ``repro.data``, which
needs no framework."""

from repro_torch.data.pipeline import ByteFileSource, SyntheticLMSource, make_source  # noqa: F401
