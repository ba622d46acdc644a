"""Elastic re-meshing, ZeRO-1 state specs and ``shard`` / ``unshard`` with a
tuple of axes in one dim, against the reference.

``repro.runtime.elastic.largest_pow2_mesh`` needs real devices, and the
block layout of ``PartitionSpec(("a", "b"))`` is read from
``NamedSharding.devices_indices_map``, so both run in one subprocess on 8
spoofed XLA host devices (``XLA_FLAGS`` before JAX loads, as
``tests/test_multidevice.py`` runs its progs), which prints them as JSON.
``drop_axis_specs`` and ``opt_state_specs`` need no device and run here,
on ``PartitionSpec`` trees turned into the port's tuples.  Everything is
held exactly: these are shapes, specs and copies of bits.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.optim import opt_state_specs as jopt_state_specs
from repro.runtime.elastic import drop_axis_specs as jdrop_axis_specs
from repro_torch.core import mesh as M
from repro_torch.optim import opt_state_specs
from repro_torch.runtime.elastic import drop_axis_specs, largest_pow2_mesh, reshard

ROOT = Path(__file__).resolve().parent.parent
MEMBERS = range(1, 9)
MODEL_MAX = (1, 2, 4, 16)
# (mesh shape, axis names, global shape, spec) for the block layouts
LAYOUTS = [((2, 4), ("a", "b"), (16, 3), (("a", "b"), None)),
           ((2, 4), ("a", "b"), (16, 3), (("b", "a"), None)),
           ((2, 4), ("a", "b"), (3, 8), (None, ("a", "b"))),
           ((2, 4), ("a", "b"), (8, 6), (("b",), "a")),
           ((2, 2, 2), ("x", "y", "z"), (8, 4), (("x", "z"), "y")),
           ((2, 2, 2), ("x", "y", "z"), (4, 8), (None, ("z", "x", "y"))),
           ((8,), ("d",), (16,), (("d",),))]

REFERENCE = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.runtime.elastic import largest_pow2_mesh

shapes = {}
for n in range(1, 9):
    for model_max in (1, 2, 4, 16):
        mesh = largest_pow2_mesh(jax.devices()[:n], ("data", "model"), model_max=model_max)
        shapes[f"{n},{model_max}"] = list(mesh.devices.shape)
layouts = []
for shape, names, gshape, spec in json.loads(sys.argv[1]):
    mesh = jax.make_mesh(tuple(shape), tuple(names), devices=jax.devices()[:int(np.prod(shape))])
    spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
    index = NamedSharding(mesh, spec).devices_indices_map(tuple(gshape))
    where = {d.id: np.argwhere(mesh.devices == d)[0].tolist() for d in mesh.devices.flat}
    layouts.append({json.dumps(where[d.id]): [[s.start or 0, s.stop or g] for s, g in
                                            zip(sl, gshape)] for d, sl in index.items()})
print(json.dumps({"shapes": shapes, "layouts": layouts}))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}:{os.environ.get('PYTHONPATH', '')}")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", REFERENCE, json.dumps(LAYOUTS)],
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("model_max", MODEL_MAX)
@pytest.mark.parametrize("n", MEMBERS)
def test_largest_pow2_mesh_matches_reference(reference, n, model_max):
    mesh = largest_pow2_mesh(range(n), ("data", "model"), model_max=model_max, device="cpu")
    assert isinstance(mesh, M.Mesh) and mesh.axis_names == ("data", "model")
    assert list(mesh.shape) == reference["shapes"][f"{n},{model_max}"]


def test_largest_pow2_mesh_needs_a_card_unless_asked_for_the_host():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the mesh takes it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        largest_pow2_mesh(range(8))


@pytest.mark.parametrize("case", range(len(LAYOUTS)))
def test_shard_with_a_tuple_of_axes_lays_blocks_out_as_shard_map(reference, case):
    """Member at mesh coordinates c holds the block that the reference's
    NamedSharding gives the device at c, and unshard rebuilds the array."""
    shape, names, gshape, spec = LAYOUTS[case]
    x = np.arange(np.prod(gshape), dtype=np.float32).reshape(gshape)
    mesh = M.Mesh(shape, names, device="cpu")
    y = M.shard(x, mesh, spec)
    assert y.shape[:len(shape)] == shape
    for coord, bounds in reference["layouts"][case].items():
        block = x[tuple(slice(a, b) for a, b in bounds)]
        np.testing.assert_array_equal(y[tuple(json.loads(coord))].numpy(), block)
    np.testing.assert_array_equal(M.unshard(y, mesh, spec).numpy(), x)


def test_shard_rejects_an_axis_twice_across_tuples():
    mesh = M.Mesh((2, 2), ("a", "b"), device="cpu")
    with pytest.raises(ValueError, match="twice"):
        M.shard(np.zeros((4, 4), np.float32), mesh, (("a", "b"), "a"))
    with pytest.raises(ValueError, match="divisible"):
        M.shard(np.zeros((6, 4), np.float32), mesh, (("a", "b"),))


def _tuples(spec):
    """A PartitionSpec as the port's spec tuple."""
    return tuple(e if e is None or isinstance(e, str) else tuple(e) for e in spec)


def _norm(spec):
    """One-axis tuples as their axis, as PartitionSpec stores them."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


DROP_CASES = [
    ({"w": P("data", "model"), "b": P(("pod", "data"), None), "c": P()}, ("pod",)),
    ({"w": P(("pod", "data"), "model"), "n": {"k": P(None, ("model", "pod"))}}, ("pod", "model")),
    ({"w": P("data"), "b": P(("data",), "model")}, ("data",)),
    ({"w": P(("a", "b", "c"), None, "d")}, ("b", "d")),
    ({"w": P("data", "model")}, ()),
]


@pytest.mark.parametrize("case", range(len(DROP_CASES)))
def test_drop_axis_specs_matches_reference(case):
    specs, missing = DROP_CASES[case]
    want = jax.tree.map(_tuples, jdrop_axis_specs(specs, missing),
                        is_leaf=lambda x: isinstance(x, P))
    port = jax.tree.map(_tuples, specs, is_leaf=lambda x: isinstance(x, P))
    got = drop_axis_specs(port, missing)
    assert jax.tree.map(_norm, got, is_leaf=lambda x: isinstance(x, tuple)) == \
        jax.tree.map(_norm, want, is_leaf=lambda x: isinstance(x, tuple))


OPT_CASES = [
    # tests/test_substrates.py::test_opt_state_specs_zero1
    ({"w": P(None, "model"), "b": P(None)}, {"w": (64, 8), "b": (7,)}, ("data",), True,
     {"data": 16}),
    ({"w": P(None, "model"), "b": P(None)}, {"w": (64, 8), "b": (7,)}, ("data",), False,
     {"data": 16}),
    ({"w": P(), "e": P("model", None)}, {"w": (12, 48, 5), "e": (8, 96)}, ("data",), True,
     {"data": 4, "model": 2}),
    ({"w": P("model"), "v": P(None, None)}, {"w": (8, 24), "v": (6, 10)}, ("pod", "data"), True,
     {"pod": 2, "data": 3}),
    ({"w": P(None, None), "n": {"k": P()}}, {"w": (16, 16), "n": {"k": (3, 32)}}, ("data",),
     True, {"data": 8}),
    ({"w": P(None)}, {"w": (16,)}, ("data",), True, None),
]


@pytest.mark.parametrize("case", range(len(OPT_CASES)))
def test_opt_state_specs_matches_reference(case):
    specs, shapes, axes, zero1, sizes = OPT_CASES[case]
    jshapes = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s, jnp.float32), shapes,
                           is_leaf=lambda x: isinstance(x, tuple))
    want = jopt_state_specs(specs, jshapes, batch_axes=axes, zero1=zero1, axis_sizes=sizes)
    port = jax.tree.map(_tuples, specs, is_leaf=lambda x: isinstance(x, P))
    tshapes = jax.tree.map(torch.zeros, shapes, is_leaf=lambda x: isinstance(x, tuple))
    got = opt_state_specs(port, tshapes, batch_axes=axes, zero1=zero1, axis_sizes=sizes)
    assert got["step"] == ()
    assert got["m"] == got["v"]
    for key in ("m", "v"):
        w = jax.tree.map(lambda s: _norm(_tuples(s)), want[key], is_leaf=lambda x: isinstance(x, P))
        g = jax.tree.map(_norm, got[key], is_leaf=lambda x: isinstance(x, tuple))
        assert g == w


def test_opt_state_specs_shards_the_moments_under_shard():
    """The ZeRO-1 spec of a moment lays it out on the mesh and back."""
    specs = opt_state_specs({"w": (None, "model")}, {"w": (64, 8)}, axis_sizes={"data": 4})
    assert specs["m"]["w"] == (("data",), "model")
    mesh = M.Mesh((4, 2), ("data", "model"), device="cpu")
    m = torch.arange(64 * 8, dtype=torch.float32).reshape(64, 8)
    y = M.shard(m, mesh, specs["m"]["w"])
    assert y.shape == (4, 2, 16, 4)
    assert torch.equal(M.unshard(y, mesh, specs["m"]["w"]), m)


RESHARD_SPECS = [(), ("data",), (None, "model"), (("data", "model"),), ("model", "data")]


@pytest.mark.parametrize("spec", RESHARD_SPECS)
def test_reshard_8_to_4_round_trips_bit_equal(spec):
    """dp_train_prog's re-mesh: the (4, 2) mesh of 8 members, then the
    (2, 2) mesh of 5 survivors, then the global arrays again."""
    gen = torch.Generator().manual_seed(3)
    tree = {"w": torch.randn(16, 8, generator=gen),
            "n": {"b": torch.randn(8, 16, generator=gen).to(torch.bfloat16)}}
    specs = {"w": spec, "n": {"b": spec}}
    mesh8 = largest_pow2_mesh(range(8), model_max=2, device="cpu")
    mesh4 = largest_pow2_mesh(range(5), model_max=2, device="cpu")
    assert (mesh8.shape, mesh4.shape) == ((4, 2), (2, 2))
    on8 = reshard(tree, specs, mesh8)
    on4 = reshard(on8, specs, mesh4, src=mesh8)
    assert on4["w"].shape[:2] == (2, 2)
    back = {"w": M.unshard(on4["w"], mesh4, spec), "n": {"b": M.unshard(on4["n"]["b"], mesh4, spec)}}
    assert torch.equal(back["w"], tree["w"])
    assert back["n"]["b"].dtype == torch.bfloat16 and torch.equal(back["n"]["b"], tree["n"]["b"])


def test_reshard_replicates_leaves_without_a_spec():
    mesh = M.Mesh((2, 2), ("data", "model"), device="cpu")
    x = torch.arange(6.0).reshape(2, 3)
    out = reshard({"a": x, "b": x}, {"a": None}, mesh)
    for leaf in out.values():
        assert leaf.shape == (2, 2, 2, 3)
        assert torch.equal(leaf, x.expand(2, 2, 2, 3))
