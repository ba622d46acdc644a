"""The port's sharding layer against the reference's, on the CPU.

``ShardingPolicy`` (``models/common.py``), every family's ``param_specs``
and ``launch``'s ``make_policy``, ``batch_axes`` and ``axis_sizes``.  A
spec of the port is the plain tuple that ``core.mesh.shard`` takes; a
reference ``PartitionSpec`` is compared as its tuple, with an entry of one
axis written as that axis (``PartitionSpec`` itself turns ``("data",)``
into ``"data"``).  The reference's specs need no devices: its
``make_policy`` reads a mesh's ``axis_names`` and ``devices.shape``, which
a stand-in object gives for any mesh shape, (16, 16) included.

A parameter spec is compared leaf by leaf, padded with ``None`` to the
leaf's rank: the port keys its specs by the reference's leaves in its own
names (``models.convert.reference_leaves``), and gives a layer-stacked
leaf its per-layer spec, which is the reference's without the leading
``None`` of the layer dim.
"""

import itertools
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.launch import mesh as jmesh
from repro.launch.steps import make_policy as jmake_policy
from repro.models import get_family as jfamily
from repro.models.common import REPLICATED as JREPLICATED
from repro.models.common import ShardingPolicy as JPolicy
from repro_torch import configs as tconfigs
from repro_torch.core.mesh import Mesh
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.steps import make_policy as tmake_policy
from repro_torch.models import get_family
from repro_torch.models.common import REPLICATED, ShardingPolicy
from repro_torch.models.convert import leaf_of, reference_leaves

MESHES = (((2, 4), ("data", "model")), ((1, 8), ("data", "model")),
          ((16, 16), ("data", "model")), ((2, 2, 4), ("pod", "data", "model")))
# the specs' meshes: a model axis of 32 leaves phi3.5-moe's 16 experts
# whole and splits their d_ff (column- and row-parallel apart)
SPEC_MESHES = MESHES[:3] + (((1, 32), ("data", "model")),)
SIZES = (1, 2, 4, 16)
DIMS = (1, 2, 3, 4, 6, 8, 12, 16, 40, 64, 128, 1408, 2048, 4096, 163840)


def _entry(e):
    if isinstance(e, tuple) and len(e) == 1:
        return e[0]
    return e


def _same(port, ref, rank: int | None = None) -> bool:
    a = tuple(_entry(e) for e in port)
    b = tuple(_entry(e) for e in tuple(ref))
    if rank is not None:
        a, b = a + (None,) * (rank - len(a)), b + (None,) * (rank - len(b))
    return a == b


def _policies(size: int):
    sizes = {"data": 2, "model": size}
    for batch, model, seq in itertools.product(((), ("data",), ("pod", "data")),
                                               ("model", None), (None, "model")):
        kw = dict(batch_axes=batch, model_axis=model, mesh_axis_sizes=dict(sizes, pod=2),
                  seq_axis=seq)
        yield JPolicy(**kw), ShardingPolicy(**kw)


ONE_DIM = ("w_col", "w_row", "embed", "act_bshd", "act_bsf", "act_bsv", "kv_cache",
           "_model_if_divisible")


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("method", ONE_DIM)
def test_policy_methods_of_one_dim_match(method, size):
    for ref, port in _policies(size):
        for dim in DIMS:
            want, got = getattr(ref, method)(dim), getattr(port, method)(dim)
            if method == "_model_if_divisible":
                assert got == want, (dim, ref)
            else:
                assert _same(got, want), (method, dim, ref, got, want)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("method", ("w_expert_col", "w_expert_row", "kv_dims"))
def test_policy_methods_of_two_dims_match(method, size):
    for ref, port in _policies(size):
        for a, b in itertools.product(DIMS, DIMS[:8]):
            want, got = getattr(ref, method)(a, b), getattr(port, method)(a, b)
            if method == "kv_dims":
                assert got == want, (a, b, ref)
            else:
                assert _same(got, want), (method, a, b, ref, got, want)


@pytest.mark.parametrize("size", SIZES)
def test_policy_methods_without_dims_match(size):
    for ref, port in _policies(size):
        assert _same(port.none(), ref.none()) and _same(port.act_bsd(), ref.act_bsd())
        assert port.align_decode_cache == ref.align_decode_cache


def test_replicated_and_defaults_match():
    for port, ref in ((REPLICATED, JREPLICATED), (ShardingPolicy(), JPolicy())):
        assert (port.batch_axes, port.model_axis, port.mesh_axis_sizes, port.seq_axis,
                port.align_decode_cache) == (ref.batch_axes, ref.model_axis,
                                              ref.mesh_axis_sizes, ref.seq_axis,
                                              ref.align_decode_cache)


def _stand_in(shape, names):
    """What the reference's mesh helpers read of a mesh."""
    return types.SimpleNamespace(axis_names=names, devices=np.empty(shape))


@pytest.mark.parametrize("shape,names", MESHES, ids=str)
def test_mesh_helpers_match(shape, names):
    port = Mesh(shape, names, device="cpu")
    ref = _stand_in(shape, names)
    assert tmesh.batch_axes(port) == jmesh.batch_axes(ref)
    assert tmesh.axis_sizes(port) == jmesh.axis_sizes(ref)


@pytest.mark.parametrize("options", [dict(), dict(shard_batch=False), dict(seq_parallel=True),
                                     dict(align_decode_cache=True)], ids=str)
@pytest.mark.parametrize("shape,names", MESHES, ids=str)
def test_make_policy_matches(shape, names, options):
    cfg, jc = tconfigs.get_config("yi_6b"), jconfigs.get_config("yi_6b")
    port = tmake_policy(cfg, Mesh(shape, names, device="cpu"), **options)
    ref = jmake_policy(jc, _stand_in(shape, names), **options)
    assert dataclasses_dict(port) == dataclasses_dict(ref)


def dataclasses_dict(policy):
    return {f: getattr(policy, f) for f in ("batch_axes", "model_axis", "mesh_axis_sizes",
                                            "seq_axis", "align_decode_cache")}


def _ref_path(key: str, cfg) -> tuple[tuple, bool]:
    """The reference's pytree path of a port leaf key, and whether the
    reference stacks it on a leading layer dim."""
    parts = key.split(".")
    stacked = "*" in parts
    parts = [p for p in parts if p != "*"]
    if parts[0] == "blocks":
        parts[0] = "layers"
    if parts[0] == "norms":
        parts = parts[1:]
    if cfg.family == "rglru_hybrid" and parts[0] == "layers":
        parts[1] = int(parts[1])
        if parts[2] == "mixer":
            parts[2] = cfg._block_kind(parts[1])
    return tuple(parts), stacked


def _at(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _leaves(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, P))[0]:
        out[tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)] = leaf
    return out


@pytest.mark.parametrize("batch", (True, False), ids=("batch", "no_batch"))
@pytest.mark.parametrize("shape,names", SPEC_MESHES, ids=str)
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_param_specs_match_the_reference(arch, shape, names, batch):
    cfg, jc = tconfigs.get_config(arch), jconfigs.get_config(arch)
    port = get_family(cfg).param_specs(
        cfg, tmake_policy(cfg, Mesh(shape, names, device="cpu"), shard_batch=batch))
    jfam = jfamily(jc)
    ref = jfam.param_specs(jc, jmake_policy(jc, _stand_in(shape, names), shard_batch=batch))
    shapes = jax.eval_shape(lambda: jfam.init(jax.random.PRNGKey(0), jc))
    ref_leaves = _leaves(ref)
    seen = set()
    for key, spec in port.items():
        path, stacked = _ref_path(key, cfg)
        want, rank = _at(ref, path), len(_at(shapes, path).shape)
        seen.add(path)
        if stacked:
            assert tuple(want)[:1] in ((), (None,)), (key, want)
            want, rank = P(*tuple(want)[1:]), rank - 1
        assert len(spec) <= rank and _same(spec, want, rank), (key, spec, want)
    assert seen == set(ref_leaves), set(ref_leaves) ^ seen


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_param_specs_cover_every_parameter(arch):
    """The specs' keys are the reference leaves of the model's parameters,
    one each (``shard_model`` looks each parameter up by ``leaf_of``)."""
    cfg = tconfigs.get_smoke_config(arch)
    model = get_family(cfg).init(torch.Generator().manual_seed(0), cfg, "cpu")
    names = [n for n, _ in model.named_parameters()]
    specs = get_family(cfg).param_specs(cfg, ShardingPolicy(mesh_axis_sizes={"model": 4}))
    assert set(specs) == set(reference_leaves(names, cfg))
    for n, p in model.named_parameters():
        assert len(specs[leaf_of(n, cfg)[0]]) <= p.ndim, n
