"""The paper's analytical NoC models, copied from ``repro.core.noc`` (params, model)."""
