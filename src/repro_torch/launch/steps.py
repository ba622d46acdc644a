"""Sharding policies of the launch tooling (``src/repro/launch/steps.py``).

``make_policy`` is the reference's; the step builders of the dry-run
tooling come after it (ROADMAP.md).
"""

from __future__ import annotations

from repro_torch.launch.mesh import axis_sizes, batch_axes
from repro_torch.models.common import ModelConfig, ShardingPolicy


def make_policy(cfg: ModelConfig, mesh, *, shard_batch: bool = True,
                seq_parallel: bool = False,
                align_decode_cache: bool = False) -> ShardingPolicy:
    return ShardingPolicy(
        batch_axes=batch_axes(mesh) if shard_batch else (),
        model_axis="model",
        mesh_axis_sizes=axis_sizes(mesh),
        seq_axis="model" if seq_parallel else None,
        align_decode_cache=align_decode_cache,
    )
