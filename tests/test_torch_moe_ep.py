"""The expert-parallel MoE and ``all_to_all`` against the reference, on the CPU.

``core.mesh.all_to_all`` is held against ``jax.lax.all_to_all`` (tiled)
under nested ``jax.vmap`` on the stacked (2, 4) mesh, for both of
``_moe_ep``'s (split, concat) pairs and one other, in int32, f32 and bf16:
it moves bytes, so the two must be equal.

``models.mlp._moe_ep`` on a stacked ``(2, 4)`` ``("data", "model")`` mesh is
held against the reference's ``_moe_ep`` (a ``shard_map``), which runs in a
subprocess on 8 spoofed XLA host devices (``XLA_FLAGS`` is set before JAX
loads) under ``jax.set_mesh``, its weights placed with ``NamedSharding``
by ``moe_param_specs``, jitted.  The cases: moonshot's and phi3.5-moe's
smoke configs, with ``moe_token_shard`` on and off and with
``seq_axis="model"`` (the tokens laid out on S as the model holds them
between blocks), at ``capacity_factor`` 1.25 (rows dropped) and 64
(none), and a sequence that the model axis does not divide (every member
routes the same tokens).  The subprocess also runs the reference's
``_route`` and ``_dispatch_indices`` in a ``shard_map`` with ``_moe_ep``'s
own token layout, so that each member's expert choices and kept rows are
the reference's.  Expert indices, kept and dropped rows and their slots
must be equal; outputs and the aux loss within 2e-4 (the reference
tests' f32 tolerance).  At ``capacity_factor`` 64 the expert-parallel MoE
is also held against the port's own ``_moe_local`` over the whole batch.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.core import mesh as M
from repro_torch.launch.steps import make_policy
from repro_torch.models import mlp

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=2e-4, atol=2e-4)
SHAPE, NAMES = (2, 4), ("data", "model")
B, S, S_ODD = 4, 16, 6
BSPEC = (("data",), None, None)
BSPEC_SEQ = (("data",), "model", None)  # sequence parallelism: S split too

# name -> (arch, capacity_factor, moe_token_shard, seq_parallel, S)
CASES = {}
for _arch in ("moonshot_v1_16b", "phi3_5_moe"):
    for _cf in (1.25, 64.0):
        for _variant, (_shard, _seq) in {"token_shard": (True, False),
                                         "replicated": (False, False),
                                         "seq_axis": (False, True)}.items():
            CASES[f"{_arch} {_variant} cf{_cf:g}"] = (_arch, _cf, _shard, _seq, S)
    CASES[f"{_arch} token_shard S{S_ODD} cf1.25"] = (_arch, 1.25, True, False, S_ODD)

REFERENCE = r"""
import os, sys, json, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np, jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import configs
from repro.launch.steps import make_policy
from repro.models import mlp

inp = dict(np.load(sys.argv[1]))
cases = json.loads(sys.argv[3])
mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
out = {}
for arch in sorted({c[0] for c in cases.values()}):
    params = mlp.init_moe_params(jax.random.PRNGKey(0), configs.get_smoke_config(arch))
    for k, v in params.items():
        out[f"{arch}/{k}"] = np.asarray(v)
for name, (arch, cf, shard, seq_par, S) in cases.items():
    jc = dataclasses.replace(configs.get_smoke_config(arch), capacity_factor=cf,
                             moe_token_shard=shard)
    pol = make_policy(jc, mesh, seq_parallel=seq_par)
    specs = mlp.moe_param_specs(jc, pol)
    params = {k: out[f"{arch}/{k}"] for k in specs}
    x = inp[f"x{S}"]
    seq = "model" if (seq_par or shard) and S % 4 == 0 else None
    with jax.set_mesh(mesh):
        placed = {k: jax.device_put(v, NamedSharding(mesh, specs[k])) for k, v in params.items()}
        xs = jax.device_put(x, NamedSharding(mesh, P("data", None, None)))
        y, aux = jax.jit(lambda p, x: mlp._moe_ep(p, x, jc, pol, 4))(placed, xs)

        def body(xs, router):
            Tl = xs.shape[0] * xs.shape[1]
            gv, gi, _ = mlp._route({"router": router}, xs.reshape(Tl, -1), jc)
            tok, e, c, keep = mlp._dispatch_indices(gi, jc.n_experts, mlp.moe_capacity(jc, Tl))
            return tuple(t[None, None] for t in (gv, gi, e, c, keep))

        routed = jax.jit(jax.shard_map(body, mesh=mesh,
                                       in_specs=(P("data", seq, None), P(None, None)),
                                       out_specs=P("data", "model"), check_vma=False))(
            xs, placed["router"])
    out[f"{name}/y"], out[f"{name}/aux"] = np.asarray(y), np.asarray(aux)
    for k, t in zip(("gate_vals", "gate_idx", "e_idx", "c_idx", "keep"), routed):
        out[f"{name}/{k}"] = np.asarray(t)
np.savez(sys.argv[2], **out)
print("REFERENCE OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_ep")
    rng = np.random.default_rng(3)
    inp = {f"x{s}": rng.standard_normal((B, s, 64)).astype(np.float32) for s in (S, S_ODD)}
    np.savez(d / "in.npz", **inp)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", REFERENCE, str(d / "in.npz"),
                           str(d / "out.npz"), json.dumps(CASES)],
                          capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert "REFERENCE OK" in proc.stdout, proc.stderr[-3000:]
    return inp, dict(np.load(d / "out.npz"))


def _cfg(arch, cf, shard):
    return dataclasses.replace(tconfigs.get_smoke_config(arch), capacity_factor=cf,
                               moe_token_shard=shard)


def _port_ep(ref_out, cfg, arch, seq_par, x, monkeypatch):
    """The port's _moe_ep on the stacked (2, 4) mesh: (global y, aux of
    every member, routing records, params).  Under sequence parallelism the
    tokens are laid out as the model holds them between blocks, each
    member with its block of S, and so is y."""
    mesh = M.Mesh(SHAPE, NAMES, device="cpu")
    pol = make_policy(cfg, mesh, seq_parallel=seq_par)
    specs = mlp.moe_param_specs(cfg, pol)
    params = {k: M.shard(torch.from_numpy(ref_out[f"{arch}/{k}"]), mesh, specs[k])
              for k in specs}
    record = {}
    real_route, real_dispatch = mlp._route, mlp._dispatch_indices

    def route(p, xf, c):
        record["gate_vals"], record["gate_idx"], aux = real_route(p, xf, c)
        return record["gate_vals"], record["gate_idx"], aux

    def dispatch(gate_idx, E, C):
        got = real_dispatch(gate_idx, E, C)
        record["e_idx"], record["c_idx"], record["keep"] = got[1:]
        return got

    monkeypatch.setattr(mlp, "_route", route)
    monkeypatch.setattr(mlp, "_dispatch_indices", dispatch)
    spec = BSPEC_SEQ if seq_par else BSPEC
    with mesh:
        y, aux = mlp._moe_ep(params, M.shard(torch.from_numpy(x), mesh, spec), cfg, pol, 4)
    return M.unshard(y, mesh, spec), aux, record, params


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_ep_matches_the_reference_shard_map(reference, case, monkeypatch):
    inp, ref = reference
    arch, cf, shard, seq_par, s = CASES[case]
    cfg = _cfg(arch, cf, shard)
    y, aux, record, _ = _port_ep(ref, cfg, arch, seq_par, inp[f"x{s}"], monkeypatch)
    for k in ("gate_idx", "e_idx", "c_idx", "keep"):
        got = record[k].numpy()
        want = ref[f"{case}/{k}"].reshape(got.shape)
        assert np.array_equal(got, want), (k, np.argwhere(got != want)[:5])
    np.testing.assert_allclose(record["gate_vals"].numpy(),
                               ref[f"{case}/gate_vals"].reshape(record["gate_vals"].shape), **TOL)
    if cf < 2 and (shard or seq_par) and s == S:  # a member's 8 tokens drop rows
        assert not record["keep"].all()
    if cf > 2:
        assert record["keep"].all()
    np.testing.assert_allclose(y.numpy(), ref[f"{case}/y"], **TOL)
    assert torch.equal(aux, aux[:1, :1].expand_as(aux))  # one value on every member
    np.testing.assert_allclose(float(aux[0, 0]), float(ref[f"{case}/aux"]), **TOL)


@pytest.mark.parametrize("case", sorted(c for c in CASES if CASES[c][1] > 2))
def test_moe_ep_without_drops_equals_the_local_moe(reference, case, monkeypatch):
    inp, ref = reference
    arch, cf, shard, seq_par, s = CASES[case]
    cfg = _cfg(arch, cf, shard)
    x = inp[f"x{s}"]
    y, _, _, _ = _port_ep(ref, cfg, arch, seq_par, x, monkeypatch)
    monkeypatch.undo()
    params = {k: torch.from_numpy(ref[f"{arch}/{k}"]) for k in ("router", "w_gate", "w_up",
                                                                 "w_down")}
    want, _ = mlp._moe_local(params, torch.from_numpy(x).reshape(-1, x.shape[-1]), cfg)
    np.testing.assert_allclose(y.numpy(), want.reshape(x.shape).numpy(), rtol=1e-5, atol=1e-5)


def test_moe_takes_the_expert_parallel_path_under_a_model_axis(reference, monkeypatch):
    """No fallback: with a model axis wider than 1 that divides n_experts,
    ``moe`` runs ``_moe_ep``; otherwise the members' local MoE."""
    inp, ref = reference
    cfg = _cfg("moonshot_v1_16b", 1.25, True)
    calls = []
    real = mlp._moe_ep
    monkeypatch.setattr(mlp, "_moe_ep", lambda *a: calls.append(1) or real(*a))
    for shape, ep in (((2, 4), True), ((4, 1), False), ((2, 3), False)):
        mesh = M.Mesh(shape, NAMES, device="cpu")
        pol = make_policy(cfg, mesh)
        specs = mlp.moe_param_specs(cfg, pol)
        params = {k: M.shard(torch.from_numpy(ref[f"moonshot_v1_16b/{k}"]), mesh, specs[k])
                  for k in specs}
        calls.clear()
        with mesh:
            mlp.moe(params, M.shard(torch.from_numpy(inp[f"x{S}"]), mesh, BSPEC), cfg, pol)
        assert calls == ([1] if ep else []), shape


A2A_PAIRS = ((0, 1), (1, 0), (1, 2))


@pytest.mark.parametrize("dtype", ("int32", "float32", "bfloat16"))
@pytest.mark.parametrize("pair", A2A_PAIRS, ids=str)
@pytest.mark.parametrize("axis", NAMES)
def test_all_to_all_matches_jax(axis, pair, dtype):
    split, concat = pair
    rng = np.random.default_rng(A2A_PAIRS.index(pair))
    x = rng.standard_normal(SHAPE + (8, 12, 4)).astype(np.float32)
    jdt = {"int32": np.int32, "float32": np.float32, "bfloat16": jax.numpy.bfloat16}[dtype]
    x = (x * 2**20).astype(np.int32) if dtype == "int32" else x.astype(jdt)

    def f(v):
        return jax.lax.all_to_all(v, axis, split, concat, tiled=True)

    want = np.asarray(jax.vmap(jax.vmap(f, axis_name="model"), axis_name="data")(x))
    t = torch.from_numpy(np.asarray(x, np.float32) if dtype == "bfloat16" else x)
    t = t.to(getattr(torch, dtype))
    with M.Mesh(SHAPE, NAMES, device="cpu"):
        got = M.all_to_all(t, axis, split, concat)
    assert got.dtype == t.dtype and tuple(got.shape) == want.shape
    assert np.array_equal(got.float().numpy() if dtype == "bfloat16" else got.numpy(),
                          want.astype(np.float32) if dtype == "bfloat16" else want)
