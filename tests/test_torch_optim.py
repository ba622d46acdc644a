"""The port's optimizer, compression, schedule and data pipeline against the
JAX reference, on the CPU.

``adamw_update`` (one and three steps, bf16 and f32 leaves, the global
clip active) and ``warmup_cosine`` at 1e-6; ``compress_int8`` equal to the
reference; ``compressed_mean`` and ``pmax`` on the stacked mesh against the
reference bodies under nested ``jax.vmap(axis_name=...)``; the data
sources' batches equal bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import data as jdata
from repro import optim as joptim
from repro_torch import data as tdata
from repro_torch import optim as toptim
from repro_torch.core import mesh as M

SHAPES = {"w": (6, 5), "b": (5,), "emb": (7, 3)}
BF16 = {"emb"}


def _leaves(seed, scale):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in SHAPES.items()}


def _jax_tree(tree):
    return {k: jnp.asarray(v, jnp.bfloat16 if k in BF16 else jnp.float32)
            for k, v in tree.items()}


def _torch_tree(tree):
    return {k: torch.from_numpy(v).to(torch.bfloat16 if k in BF16 else torch.float32)
            for k, v in tree.items()}


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("lr_scale", [1.0, 0.37])
def test_adamw_update_matches_reference(steps, lr_scale):
    cfg_j = joptim.AdamWConfig(lr=1e-2, weight_decay=0.1, grad_clip=1.0)
    cfg_t = toptim.AdamWConfig(lr=1e-2, weight_decay=0.1, grad_clip=1.0)
    init = _leaves(0, 1.0)
    pj, pt = _jax_tree(init), _torch_tree(init)
    sj, st = joptim.adamw_init(pj), toptim.adamw_init(pt)
    for i in range(steps):
        g = _leaves(10 + i, 3.0)  # global norm ~20: the clip is active
        pj, sj, mj = joptim.adamw_update(pj, _jax_tree(g), sj, cfg_j, jnp.float32(lr_scale))
        pt, st, mt = toptim.adamw_update(pt, _torch_tree(g), st, cfg_t,
                                         torch.tensor(lr_scale, dtype=torch.float32))
        assert float(mj["grad_norm"]) > 1.0
        np.testing.assert_allclose(mt["grad_norm"].item(), float(mj["grad_norm"]), rtol=1e-6)
    assert int(st["step"]) == int(sj["step"]) == steps
    for k in SHAPES:
        assert pt[k].dtype == (torch.bfloat16 if k in BF16 else torch.float32)
        assert st["m"][k].dtype == st["v"][k].dtype == torch.float32
        np.testing.assert_allclose(_np(pt[k]), _np(pj[k]), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(_np(st["m"][k]), _np(sj["m"][k]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(_np(st["v"][k]), _np(sj["v"][k]), rtol=1e-6, atol=1e-7)


def test_adamw_update_leaves_its_arguments():
    p = {"w": torch.ones(3)}
    s = toptim.adamw_init(p)
    new, s2, _ = toptim.adamw_update(p, {"w": torch.ones(3)}, s, toptim.AdamWConfig())
    assert torch.equal(p["w"], torch.ones(3)) and int(s["step"]) == 0 and int(s2["step"]) == 1
    assert not torch.equal(new["w"], p["w"])


def test_global_norm_matches_reference():
    g = _leaves(3, 2.0)
    np.testing.assert_allclose(toptim.global_norm(_torch_tree(g)).item(),
                               float(joptim.adamw.global_norm(_jax_tree(g))), rtol=1e-6)


@pytest.mark.parametrize("warmup,total", [(100, 5000), (0, 10), (20, 1000)])
def test_warmup_cosine_matches_reference(warmup, total):
    for step in (0, 1, warmup // 2, warmup, warmup + 1, (warmup + total) // 2, total - 1,
                 total, total + 7):
        ref = float(joptim.warmup_cosine(step, warmup=warmup, total=total, min_ratio=0.1))
        got = toptim.warmup_cosine(step, warmup=warmup, total=total, min_ratio=0.1)
        got_t = toptim.warmup_cosine(torch.tensor(step, dtype=torch.int32), warmup=warmup,
                                     total=total, min_ratio=0.1)
        assert isinstance(got, float) and got_t.dtype == torch.float32
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got_t.item(), ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("with_err", [False, True])
def test_compress_int8_equals_reference(with_err):
    g = np.random.default_rng(4).standard_normal(1000).astype(np.float32) * 0.01
    err = np.random.default_rng(5).standard_normal(1000).astype(np.float32) * 1e-4 \
        if with_err else None
    qj, sj, ej = joptim.compress_int8(jnp.asarray(g), None if err is None else jnp.asarray(err))
    qt, s_t, et = toptim.compress_int8(torch.from_numpy(g),
                                       None if err is None else torch.from_numpy(err))
    assert qt.dtype == torch.int8
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert s_t.item() == float(sj)
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    np.testing.assert_array_equal(toptim.decompress_int8(qt, s_t).numpy(),
                                  np.asarray(joptim.decompress_int8(qj, sj)))


def _stacked(seed, lead, shapes):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(lead + s) * rng.uniform(0.1, 3, lead + (1,) * len(s))
                ).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("with_err", [False, True])
@pytest.mark.parametrize("axis", ["a", "b"])
def test_compressed_mean_matches_reference_on_a_nested_mesh(axis, with_err):
    shapes = {"w": (4, 3), "b": (3,)}
    lead = (2, 4)  # mesh a=2, b=4
    grads = _stacked(0, lead, shapes)
    errs = _stacked(1, lead, shapes) if with_err else None

    def body(g, e):
        return joptim.compressed_mean(g, axis, e)

    if with_err:
        ref = jax.vmap(jax.vmap(body, axis_name="b"), axis_name="a")(
            jax.tree.map(jnp.asarray, grads), jax.tree.map(lambda x: jnp.asarray(x) * 1e-3, errs))
    else:
        ref = jax.vmap(jax.vmap(lambda g: body(g, None), axis_name="b"), axis_name="a")(
            jax.tree.map(jnp.asarray, grads))
    with M.Mesh(lead, ("a", "b"), device="cpu"):
        got = toptim.compressed_mean({k: torch.from_numpy(v) for k, v in grads.items()}, axis,
                                     None if errs is None else
                                     {k: torch.from_numpy(v) * 1e-3 for k, v in errs.items()})
    for k in shapes:
        np.testing.assert_allclose(got[0][k].numpy(), np.asarray(ref[0][k]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got[1][k].numpy(), np.asarray(ref[1][k]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("axis", ["a", "b"])
def test_pmax_matches_reference_on_a_nested_mesh(axis, dtype):
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, 4, 5, 3)) * 1e3).astype(dtype)
    ref = jax.vmap(jax.vmap(lambda v: jax.lax.pmax(v, axis), axis_name="b"), axis_name="a")(
        jnp.asarray(x))
    with M.Mesh((2, 4), ("a", "b"), device="cpu"):
        got = M.pmax(torch.from_numpy(x), axis)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("step", [0, 1, 42, 1000])
def test_synthetic_source_equals_reference(step):
    kw = dict(vocab=151936, seq_len=33, global_batch=3, seed=5, branching=4)
    got = tdata.SyntheticLMSource(**kw).batch_at(step)
    ref = jdata.SyntheticLMSource(**kw).batch_at(step)
    for k in ("tokens", "labels"):
        assert got[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(got[k], ref[k])


def test_byte_file_source_and_make_source_equal_reference(tmp_path):
    p = tmp_path / "corpus.txt"
    p.write_bytes(bytes(range(256)) * 3 + b"hello world" * 9)
    for step in (0, 3):
        got = tdata.make_source("bytes", path=str(p), seq_len=16, global_batch=4, seed=2)
        ref = jdata.make_source("bytes", path=str(p), seq_len=16, global_batch=4, seed=2)
        assert got.vocab == ref.vocab == 256
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got.batch_at(step)[k], ref.batch_at(step)[k])
    with pytest.raises(ValueError):
        tdata.make_source("nope")
