"""The rank mesh (``core.mesh.RankMesh``): one process per member, gloo on
the host, held against the stacked mesh on the same inputs.

Eight ranks are started once for the module (``torch.multiprocessing``
spawn, a ``file://`` rendezvous under a per-test temporary directory, one
torch thread each, a deadline of their own).  Each rank builds a ``(2, 4)``
and an ``(8,)`` mesh, runs every axis function, every schedule of
``core/schedules.py`` and ``compressed_mean`` over each axis on its member's
slice of one stacked input, then 5 steps of the data-parallel trainer on
the ``(8,)`` mesh with a checkpoint, and saves what it got.  The tests
compare each rank's result with the stacked mesh's for its member.

Tolerances.  Integers, float16 and float64 must be equal: both meshes sum
integers exactly in int64 and add f16 / f64 member by member in member
order.  float32 sums are gloo's ``all_reduce`` on the ranks and the
``reduce_nway`` router's plain order on the stack: each result is a sum of
8 terms, so the two may differ by a few roundings, held at 1e-6 of the sum
of |terms|.  bfloat16 is summed in f32 on both and rounded once, so it may
differ by one bf16 ulp (2^-8 relative) where the f32 sums round apart.
``pmax``, the software schedules (``ppermute`` and the same adds in the
same order), ``compressed_mean`` (an exact max, an exact integer sum) and
the trainer (per-member gradients from the same ops on one thread) must
be equal.

The model-parallel half: each rank also runs ``all_to_all`` (both of the
expert-parallel MoE's (split, concat) pairs and one other, in int32, f32
and bf16) over each axis, and the sharded prefill of a dense (yi-6b) and
an MoE (moonshot) smoke model on a ``(2, 4)`` ``("data", "model")`` rank
mesh, laid out by ``shard_model``.  All of it must be bit-equal to the
stacked mesh: ``all_to_all`` moves bytes, and a rank mesh's f32 ``psum``
sends each member its block of every member's rows (``all_to_all``),
which it reduces with the ``reduce_nway`` router in member order, as the
stacked mesh does, before the summed blocks are gathered.

Sharded training: on the ``(2, 4)`` rank mesh each rank differentiates
every collective (its transpose runs the mirrored collective on the ranks)
and the sharded ``loss_fn`` of the dense and the MoE smoke model, with
sequence parallelism off and on, and runs 2 steps of ``Trainer(policy=,
mesh=)`` with a checkpoint of global leaves (a collective), then resumes
it for a third.  The gradients (``global_grads``: the copies' shares
summed by ``psum`` on the ranks, by the sum over the mesh dims on the
stack) and losses must equal the stacked mesh's within 1e-6 (of each
leaf's largest gradient; the two meshes seed the backward with 1/8 on each
rank and by the mean over the stacked members, and autograd adds a
gradient's contributions in its own order on each), and the parameters
after 3 steps at the trainer tests' rtol 1e-4 / atol 1e-5 (AdamW scales
each element's step to about ``lr``, whatever its gradient's size).
"""

import dataclasses
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.configs import get_smoke_config
from repro_torch.core import mesh as M
from repro_torch.core import schedules as S
from repro_torch.data import SyntheticLMSource
from repro_torch.launch.steps import make_policy
from repro_torch.models import get_family
from repro_torch.models.convert import global_grads, shard_model, unshard_tensors
from repro_torch.optim import AdamWConfig, compressed_mean
from repro_torch.runtime.elastic import largest_pow2_mesh
from repro_torch.runtime.trainer import Trainer, TrainerConfig

WORLD = 8
MESHES = (((2, 4), ("a", "b")), ((8,), ("x",)))
LOCAL = (8, 6)
DEADLINE_S = 120
STEPS = 5


def _ring(n):
    return [(i, (i + 1) % n) for i in range(n)]


def _k():
    return M.current().stacked


# name -> (dtype, fn(x, axis)): every axis function, in each dtype that has
# its own arithmetic
AXIS_CASES = {
    "psum f32": ("float32", lambda x, a: M.psum(x, a)),
    "psum bf16": ("bfloat16", lambda x, a: M.psum(x, a)),
    "psum int32 above 2^24": ("int32", lambda x, a: M.psum(x, a)),
    "psum f16": ("float16", lambda x, a: M.psum(x, a)),
    "psum f64": ("float64", lambda x, a: M.psum(x, a)),
    "pmax f32": ("float32", lambda x, a: M.pmax(x, a)),
    "pmax int32 above 2^24": ("int32", lambda x, a: M.pmax(x, a)),
    "psum_scatter f32 tiled": ("float32", lambda x, a: M.psum_scatter(x, a, tiled=True)),
    "psum_scatter f32": ("float32", lambda x, a: M.psum_scatter(
        x.narrow(_k(), 0, M.axis_size(a)), a, tiled=False)),
    "psum_scatter int32 tiled": ("int32", lambda x, a: M.psum_scatter(x, a, tiled=True)),
    "psum_scatter f64 tiled": ("float64", lambda x, a: M.psum_scatter(x, a, tiled=True)),
    "all_gather f32 tiled": ("float32", lambda x, a: M.all_gather(x, a, tiled=True)),
    "all_gather f32": ("float32", lambda x, a: M.all_gather(x, a, tiled=False)),
    "all_gather bf16 tiled": ("bfloat16", lambda x, a: M.all_gather(x, a, tiled=True)),
    "ppermute f32 ring": ("float32", lambda x, a: M.ppermute(x, a, _ring(M.axis_size(a)))),
    "ppermute int32 xor": ("int32", lambda x, a: M.ppermute(
        x, a, [(i, i ^ 1) for i in range(M.axis_size(a))])),
    "axis_index": ("float32", lambda x, a: M.lift(M.axis_index(a), x).expand(x.shape) + 0),
    "take and put": ("float32", lambda x, a: M.put(
        x, M.axis_index(a) % x.shape[_k()], M.take(x, M.axis_index(a) % x.shape[_k()], _k())
        * 2, _k())),
}
for _s in S.SCHEDULES:
    AXIS_CASES[f"broadcast {_s}"] = ("float32", lambda x, a, s=_s: S.broadcast(
        x, a, root=1, schedule=s, chunks=2))
    AXIS_CASES[f"all_reduce {_s}"] = ("float32", lambda x, a, s=_s: S.all_reduce(
        x, a, schedule=s))
    AXIS_CASES[f"all_reduce {_s} int32"] = ("int32", lambda x, a, s=_s: S.all_reduce(
        x, a, schedule=s))
    AXIS_CASES[f"all_gather {_s}"] = ("float32", lambda x, a, s=_s: S.all_gather(
        x, a, schedule=s))
    AXIS_CASES[f"reduce_scatter {_s}"] = ("float32", lambda x, a, s=_s: S.reduce_scatter(
        x, a, schedule=s))
    AXIS_CASES[f"barrier {_s}"] = ("int32", lambda x, a, s=_s: S.barrier(a, schedule=s))


def _compressed(x, a):
    """The mean and the new residual of one leaf, side by side."""
    mean, err = compressed_mean({"g": x}, a, {"g": 1e-3 * x.flip(-1)})
    return torch.stack([mean["g"], err["g"]], dim=-1)


AXIS_CASES["compressed_mean"] = ("float32", _compressed)
# f32 cases whose results are sums in another order on the two meshes
SUMMED = ("psum f32", "psum bf16", "psum_scatter f32 tiled", "psum_scatter f32",
          "all_reduce native", "reduce_scatter native")


# name -> (dtype, split_axis, concat_axis) of the all_to_all cases
A2A_CASES = {f"all_to_all {dt} {s}->{c}": (dt, s, c)
             for dt in ("int32", "float32", "bfloat16") for s, c in ((0, 1), (1, 0), (0, 0))}
A2A_LOCAL = (8, 8, 3)
TP_ARCHS = ("yi_6b", "moonshot_v1_16b")
TP_TOKENS = (4, 16)
# the collectives whose gradients are held: name -> fn(x, axis)
GRAD_CASES = {
    "psum": lambda x, a: M.psum(x, a),
    "psum_scatter": lambda x, a: M.psum_scatter(x, a, tiled=True),
    "all_gather tiled": lambda x, a: M.all_gather(x, a, tiled=True),
    "all_gather": lambda x, a: M.all_gather(x, a, tiled=False),
    "all_to_all": lambda x, a: M.all_to_all(x, a, 0, 1),
    "ppermute ring": lambda x, a: M.ppermute(x, a, _ring(M.axis_size(a))),
}
TRAIN_ARCH = "qwen1_5_0_5b"


def _axes():
    return [(shape, names, a) for shape, names in MESHES for a in names]


def _a2a_input(shape, case: str) -> torch.Tensor:
    dtype = A2A_CASES[case][0]
    rng = np.random.default_rng(sorted(A2A_CASES).index(case) + 100 * len(shape))
    x = rng.integers(-2**30, 2**30, shape + A2A_LOCAL) if dtype == "int32" else \
        rng.standard_normal(shape + A2A_LOCAL)
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _tp_model(arch: str):
    """The smoke model of ``arch`` from seed 0, and its prompt tokens."""
    cfg = get_smoke_config(arch)
    model = get_family(cfg).init(torch.Generator().manual_seed(0), cfg, "cpu")
    tokens = torch.randint(0, cfg.vocab, TP_TOKENS, generator=torch.Generator().manual_seed(1))
    return cfg, model, tokens


def _tp_prefill(arch: str, mesh):
    """The sharded prefill of ``arch`` on ``mesh``: (global logits, the
    member's cache)."""
    cfg, model, tokens = _tp_model(arch)
    policy = make_policy(cfg, mesh)
    shard_model(model, mesh, policy)
    logits, cache = get_family(cfg).prefill(model, tokens, cfg, policy)
    return logits, cache


def _grad_of(case: str, x: torch.Tensor, axis: str) -> torch.Tensor:
    """The gradient of sum(y * cos(3 y)) (y held constant in the weight) for
    y = the collective of ``x``: one cotangent that both meshes agree on."""
    x = x.detach().requires_grad_()
    y = GRAD_CASES[case](x, axis)
    return torch.autograd.grad((y * torch.cos(3 * y.detach())).sum(), x)[0]


def _tp_grads(arch: str, mesh, seq_parallel: bool):
    """The sharded loss of ``arch`` on ``mesh`` and its global gradients by
    reference leaf."""
    cfg, model, tokens = _tp_model(arch)
    policy = make_policy(cfg, mesh, seq_parallel=seq_parallel)
    shard_model(model, mesh, policy).requires_grad_(True)
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
    loss = get_family(cfg).loss_fn(model, batch, cfg, policy)
    names = [n for n, _ in model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))
    return loss.detach(), global_grads(model, grads)


def _tp_trainer(mesh, **kw):
    cfg = get_smoke_config(TRAIN_ARCH)
    return Trainer(cfg, TrainerConfig(adamw=AdamWConfig(lr=1e-3), warmup=1, total_steps=10, **kw),
                   mesh=mesh, policy=make_policy(cfg, mesh, seq_parallel=True))


def _tp_training(mesh, root: str):
    """2 sharded steps with a checkpoint, then a new trainer resumed for a
    third: (losses of both, the global parameters)."""
    cfg = get_smoke_config(TRAIN_ARCH)
    src = SyntheticLMSource(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=1)
    first = _tp_trainer(mesh, ckpt_dir=root, ckpt_every=1)
    first.fit(src, steps=2, resume=False)
    again = _tp_trainer(mesh, ckpt_dir=root)
    model, _ = again.fit(src, steps=3)
    losses = [m["loss"] for m in first.metrics_log + again.metrics_log]
    return losses, unshard_tensors(model, {k: p.detach() for k, p in model.named_parameters()})


def _input(shape, case: str, dtype: str) -> np.ndarray:
    seed = sorted(AXIS_CASES).index(case) * 7 + len(shape)
    rng = np.random.default_rng(seed)
    full = shape + LOCAL
    if dtype == "int32":
        return rng.integers(2**24, 2**25, full).astype(np.int32)
    return rng.standard_normal(full).astype(np.float64 if dtype == "float64" else np.float32)


def _torch(x: np.ndarray, dtype: str) -> torch.Tensor:
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _tiny_cfg():
    cfg = get_smoke_config("qwen1_5_0_5b")
    return dataclasses.replace(cfg, n_layers=2, d_model=32, n_heads=2,
                               n_kv_heads=2, head_dim=16, d_ff=64, vocab=64)


def _tcfg(**kw):
    return TrainerConfig(compress_grads=True, dp_axis="data",
                         adamw=AdamWConfig(lr=3e-3, weight_decay=0.0), warmup=2,
                         total_steps=20, **kw)


def _source(cfg):
    return SyntheticLMSource(vocab=cfg.vocab, seq_len=16, global_batch=16, seed=0, branching=2)


def _rank_main(rank: int, root: str):
    """One member: every case on both meshes, then the trainer."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{root}/rendezvous", rank=rank,
                            world_size=WORLD)
    out = {}
    for shape, names in MESHES:
        with M.RankMesh(shape, names, device="cpu") as mesh:
            for case, (dtype, fn) in AXIS_CASES.items():
                x = _torch(_input(shape, case, dtype), dtype)[mesh.coord]
                for a in names:
                    out[(shape, a, case)] = fn(x, a)
            for case, (_, split, concat) in A2A_CASES.items():
                x = _a2a_input(shape, case)[mesh.coord]
                for a in names:
                    out[(shape, a, case)] = M.all_to_all(x, a, split, concat)
            if shape == (2, 4):
                out["layout"] = (mesh.coord, dict(mesh._peers))
    tp_mesh = M.RankMesh((2, 4), ("data", "model"), device="cpu")
    for arch in TP_ARCHS:
        out[("tp", arch)] = _tp_prefill(arch, tp_mesh)
    with tp_mesh:
        for case in GRAD_CASES:
            x = _torch(_grad_input(), "float32")[tp_mesh.coord]
            for a in tp_mesh.axis_names:
                out[("grad", a, case)] = _grad_of(case, x, a)
    for arch in TP_ARCHS:
        for sp in (False, True):
            out[("tp grads", arch, sp)] = _tp_grads(arch, tp_mesh, sp)
    out["tp training"] = _tp_training(tp_mesh, f"{root}/tp_ckpt")
    # 3 ranks lost: the survivors' (2, 2) mesh holds ranks 0-3; ranks 4-7
    # build it too (its groups are collective) and are not members
    survivors = largest_pow2_mesh(range(5), model_max=2, device="cpu", ranks=True)
    global_x = torch.arange(4 * 6, dtype=torch.float32).reshape(4, 6)
    spec = (("data", "model"), None)
    if survivors.member:
        block = M.shard(global_x, survivors, spec)
        out["elastic"] = (survivors.shape, survivors.coord, block,
                          M.unshard(block, survivors, spec))
    else:
        out["elastic"] = (survivors.shape, None, None, None)
    cfg = _tiny_cfg()
    mesh = M.RankMesh((WORLD,), ("data",), device="cpu")
    tr = Trainer(cfg, _tcfg(ckpt_dir=f"{root}/ckpt", ckpt_every=2), mesh=mesh)
    model, _ = tr.fit(_source(cfg), steps=STEPS, resume=False)
    out["losses"] = [m["loss"] for m in tr.metrics_log]
    out["params"] = {k: p.detach() for k, p in model.named_parameters()}
    out["err"] = tr.state[2]
    again = Trainer(cfg, _tcfg(ckpt_dir=f"{root}/ckpt"), mesh=mesh)
    (_, opt_state, err), step, _ = again.recover(again.init_state())
    out["recovered"] = (step, int(opt_state["step"]), err)
    torch.save(out, f"{root}/rank{rank}.pt")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("gloo_ranks")
    t0 = time.perf_counter()
    ctx = mp.start_processes(_rank_main, args=(str(root),), nprocs=WORLD, join=False,
                             start_method="spawn")
    try:
        while not ctx.join(timeout=1):
            if time.perf_counter() - t0 > DEADLINE_S:
                raise TimeoutError(f"gloo ranks still running after {DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)
    print(f"8 gloo ranks took {time.perf_counter() - t0:.1f} s")
    return root, [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _grad_input() -> np.ndarray:
    return np.random.default_rng(11).standard_normal((2, 4) + A2A_LOCAL).astype(np.float32)


def _stacked_one_thread(fn, *args):
    """``fn`` on the stacked mesh with one torch thread, the ranks' sums."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn(*args)
    finally:
        torch.set_num_threads(threads)


def _coord(rank, shape):
    return tuple(int(c) for c in np.unravel_index(rank, shape))


@pytest.mark.parametrize("case", sorted(AXIS_CASES))
@pytest.mark.parametrize("shape,names,axis", _axes(), ids=lambda v: str(v))
def test_rank_mesh_matches_the_stacked_mesh(ranks, shape, names, axis, case):
    dtype, fn = AXIS_CASES[case]
    x = _torch(_input(shape, case, dtype), dtype)
    with M.Mesh(shape, names, device="cpu"):
        want = fn(x, axis)
    for rank, got in enumerate(ranks[1]):
        c = _coord(rank, shape)
        g, w = got[(shape, axis, case)], want[c]
        assert g.dtype == w.dtype and g.shape == w.shape, (rank, g.shape, w.shape)
        if case not in SUMMED:
            assert torch.equal(g, w), (rank, (g.double() - w.double()).abs().max())
        elif dtype == "bfloat16":
            assert ((g.float() - w.float()).abs() <= 2**-8 * w.float().abs()).all(), rank
        else:
            scale = x.abs().sum(tuple(range(len(shape)))).max().item()
            assert (g - w).abs().max().item() <= 1e-6 * scale, rank


@pytest.mark.parametrize("case", sorted(A2A_CASES))
@pytest.mark.parametrize("shape,names,axis", _axes(), ids=lambda v: str(v))
def test_all_to_all_on_ranks_is_bit_equal_to_the_stacked_mesh(ranks, shape, names, axis, case):
    _, split, concat = A2A_CASES[case]
    with M.Mesh(shape, names, device="cpu"):
        want = M.all_to_all(_a2a_input(shape, case), axis, split, concat)
    for rank, got in enumerate(ranks[1]):
        g, w = got[(shape, axis, case)], want[_coord(rank, shape)]
        assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w), rank


@pytest.mark.parametrize("arch", TP_ARCHS)
def test_sharded_prefill_on_ranks_is_bit_equal_to_the_stacked_mesh(ranks, arch):
    """The (2, 4) rank mesh's sharded prefill: every rank's logits and cache
    block equal the stacked mesh's, bit for bit."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks' summation orders
    try:
        mesh = M.Mesh((2, 4), ("data", "model"), device="cpu")
        logits, cache = _tp_prefill(arch, mesh)
    finally:
        torch.set_num_threads(threads)
    for rank, out in enumerate(ranks[1]):
        got_logits, got_cache = out[("tp", arch)]
        c = _coord(rank, (2, 4))
        assert torch.equal(got_logits, logits), (rank, (got_logits - logits).abs().max())
        assert torch.equal(got_cache.k, cache.k[c]) and torch.equal(got_cache.v, cache.v[c]), rank


def test_rank_mesh_coordinates_and_groups_are_row_major(ranks):
    """Rank r is member (r // 4, r % 4) of the (2, 4) mesh; its "a" group
    holds the ranks of its column, its "b" group those of its row."""
    for rank, out in enumerate(ranks[1]):
        coord, peers = out["layout"]
        assert coord == (rank // 4, rank % 4)
        assert peers == {"a": [rank % 4, rank % 4 + 4], "b": [4 * (rank // 4) + j for j in range(4)]}


def test_largest_pow2_mesh_over_surviving_ranks(ranks):
    """5 of 8 ranks survive: ranks 0-3 form the (2, 2) rank mesh, each holds
    its block of P(("data", "model")) and rebuilds the global array."""
    x = torch.arange(4 * 6, dtype=torch.float32).reshape(4, 6)
    for rank, out in enumerate(ranks[1]):
        shape, coord, block, back = out["elastic"]
        assert shape == (2, 2)
        if rank >= 4:
            assert coord is None
            continue
        assert coord == (rank // 2, rank % 2)
        assert torch.equal(block, x[rank:rank + 1])
        assert torch.equal(back, x)


def test_dp_trainer_on_ranks_equals_the_stacked_trainer(ranks):
    """5 compressed steps on 8 gloo ranks against 8 stacked members, from
    the same seed: equal losses and parameters, every rank the same."""
    _, got = ranks
    cfg = _tiny_cfg()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks' summation orders
    try:
        tr = Trainer(cfg, _tcfg(), mesh=M.Mesh((WORLD,), ("data",), device="cpu"))
        model, _ = tr.fit(_source(cfg), steps=STEPS, resume=False)
    finally:
        torch.set_num_threads(threads)
    want = [m["loss"] for m in tr.metrics_log]
    for rank, out in enumerate(got):
        assert out["losses"] == want, rank  # member 0's loss on every rank
        for k, p in model.named_parameters():
            assert torch.equal(out["params"][k], p.detach()), (rank, k)
        for k, e in tr.state[2].items():
            assert torch.equal(out["err"][k], e[rank]), (rank, k)


def test_only_rank0_writes_and_every_rank_restores_member0s_residuals(ranks):
    root, got = ranks
    steps = sorted(int(p.name.split("_")[1]) for p in (Path(root) / "ckpt").glob("ckpt_*"))
    assert steps == [2, 4, 5]
    for rank, out in enumerate(got):
        step, opt_step, err = out["recovered"]
        assert (step, opt_step) == (STEPS, STEPS)
        for k, e in err.items():
            assert torch.equal(e, got[0]["err"][k]), (rank, k)  # member 0's, everywhere


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
@pytest.mark.parametrize("axis", ("data", "model"))
def test_collective_gradients_on_ranks_equal_the_stacked_mesh(ranks, axis, case):
    with M.Mesh((2, 4), ("data", "model"), device="cpu"):
        want = _grad_of(case, _torch(_grad_input(), "float32"), axis)
    for rank, out in enumerate(ranks[1]):
        got, w = out[("grad", axis, case)], want[_coord(rank, (2, 4))]
        assert got.shape == w.shape and (got - w).abs().max().item() <= 1e-6, rank


@pytest.mark.parametrize("seq_parallel", (False, True))
@pytest.mark.parametrize("arch", TP_ARCHS)
def test_sharded_gradients_on_ranks_equal_the_stacked_mesh(ranks, arch, seq_parallel):
    loss, want = _stacked_one_thread(_tp_grads, arch, M.Mesh((2, 4), ("data", "model"),
                                                             device="cpu"), seq_parallel)
    for rank, out in enumerate(ranks[1]):
        got_loss, got = out[("tp grads", arch, seq_parallel)]
        assert abs(got_loss.item() - loss.item()) <= 1e-6 * abs(loss.item()), rank
        assert sorted(got) == sorted(want)
        for leaf, w in want.items():
            scale = w.abs().max().item()
            assert (got[leaf] - w).abs().max().item() <= 1e-6 * scale, (rank, leaf)


def test_sharded_trainer_on_ranks_equals_the_stacked_trainer(ranks, tmp_path):
    """2 steps with a checkpoint of global leaves and a resumed third, on
    the ranks and on the stack: equal losses and global parameters."""
    losses, params = _stacked_one_thread(
        _tp_training, M.Mesh((2, 4), ("data", "model"), device="cpu"), str(tmp_path))
    for rank, out in enumerate(ranks[1]):
        got_losses, got = out["tp training"]
        np.testing.assert_allclose(got_losses, losses, rtol=1e-6, err_msg=str(rank))
        for k, w in params.items():  # the trainer tests' tolerance (AdamW normalises steps)
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=f"rank {rank}: {k}")
