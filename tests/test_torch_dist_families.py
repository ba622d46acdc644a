"""The sharded hybrid, rwkv6 and whisper on the rank mesh (``core.mesh.RankMesh``):
one process per member, gloo on the host, held against the stacked mesh.

Eight ranks are started once for the module (``torch.multiprocessing``
spawn, a ``file://`` rendezvous under a per-test temporary directory, one
torch thread each, a deadline of their own).  On a ``(2, 4)`` ``("data",
"model")`` rank mesh each rank lays out the smoke model of each family
(seed 0) by ``shard_model`` under ``make_policy`` and runs, with sequence
parallelism off and on, the sharded ``prefill`` and a ``decode_step``
after it, and the sharded ``loss_fn`` with its global gradients
(``global_grads``).  The tests hold each rank's logits and cache block
bit-equal to the stacked mesh's member, as ``tests/test_torch_dist.py``
holds the transformer's: a rank mesh's f32 ``psum`` reduces each member's
block of every member's rows with the ``reduce_nway`` router in member
order, as the stacked mesh does.  The loss and gradients are held as that
file holds the transformer's, within 1e-6 of each leaf's largest gradient:
the two meshes seed the backward with 1/8 on each rank and by the mean over
the stacked members, and autograd adds a gradient's contributions in its
own order on each.
"""

import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.configs import get_smoke_config
from repro_torch.core import mesh as M
from repro_torch.launch.steps import make_policy
from repro_torch.models import get_family
from repro_torch.models.convert import global_grads, shard_model

WORLD = 8
SHAPE, NAMES = (2, 4), ("data", "model")
ARCHS = ("recurrentgemma_2b", "rwkv6_3b", "whisper_base")
B, S = 4, 16
DEADLINE_S = 120


def _inputs(arch: str):
    """(config, the smoke model from seed 0, prompt batch, next tokens,
    loss batch)."""
    cfg = get_smoke_config(arch)
    model = get_family(cfg).init(torch.Generator().manual_seed(0), cfg, "cpu")
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (B, S + 1), generator=gen)
    batch = {"tokens": tokens[:, :S], "labels": tokens[:, 1:]}
    prompt = tokens[:, :S]
    if cfg.family == "whisper":
        frames = torch.randn(B, cfg.encoder_len, cfg.d_model, generator=gen)
        batch["frames"] = frames
        prompt = {"frames": frames, "tokens": prompt}
    return cfg, model, prompt, tokens[:, S:], batch


def _tensors(tree) -> list:
    """The tensors of a cache, in order (None entries left out)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if tree is None:
        return []
    return [t for node in tree for t in _tensors(node)]


def _serve(arch: str, mesh, seq_parallel: bool):
    """(prefill logits, decode logits, the member's cache tensors after the
    prefill and after the decode)."""
    cfg, model, prompt, nxt, _ = _inputs(arch)
    fam = get_family(cfg)
    policy = make_policy(cfg, mesh, seq_parallel=seq_parallel)
    shard_model(model, mesh, policy)
    logits, cache = fam.prefill(model, prompt, cfg, policy, max_len=S + 1)
    prefilled = [t.clone() for t in _tensors(cache)]
    dlogits, cache = fam.decode_step(model, cache, nxt, S, cfg, policy)
    return logits, dlogits, prefilled, _tensors(cache)


def _grads(arch: str, mesh, seq_parallel: bool):
    """The sharded loss and its global gradients by reference leaf."""
    cfg, model, _, _, batch = _inputs(arch)
    policy = make_policy(cfg, mesh, seq_parallel=seq_parallel)
    shard_model(model, mesh, policy).requires_grad_(True)
    loss = get_family(cfg).loss_fn(model, batch, cfg, policy)
    names = [n for n, _ in model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))
    return loss.detach(), global_grads(model, grads)


def _rank_main(rank: int, root: str):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{root}/rendezvous", rank=rank,
                            world_size=WORLD)
    mesh = M.RankMesh(SHAPE, NAMES, device="cpu")
    out = {}
    for arch in ARCHS:
        for sp in (False, True):
            out[("serve", arch, sp)] = _serve(arch, mesh, sp)
            out[("grads", arch, sp)] = _grads(arch, mesh, sp)
    torch.save(out, f"{root}/rank{rank}.pt")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("gloo_families")
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
    return [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _stacked_one_thread(fn, *args):
    """``fn`` on the stacked mesh with one torch thread, the ranks' sums."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn(*args)
    finally:
        torch.set_num_threads(threads)


def _coord(rank):
    return tuple(int(c) for c in np.unravel_index(rank, SHAPE))


@pytest.mark.parametrize("seq_parallel", (False, True), ids=["sp=False", "sp=True"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_and_decode_on_ranks_are_bit_equal_to_the_stacked_mesh(
        ranks, arch, seq_parallel):
    logits, dlogits, prefilled, decoded = _stacked_one_thread(
        _serve, arch, M.Mesh(SHAPE, NAMES, device="cpu"), seq_parallel)
    for rank, out in enumerate(ranks):
        got_logits, got_dlogits, got_prefilled, got_decoded = out[("serve", arch, seq_parallel)]
        c = _coord(rank)
        assert torch.equal(got_logits, logits), (rank, (got_logits - logits).abs().max())
        assert torch.equal(got_dlogits, dlogits), (rank, (got_dlogits - dlogits).abs().max())
        for got, want in ((got_prefilled, prefilled), (got_decoded, decoded)):
            assert len(got) == len(want)
            for i, (g, w) in enumerate(zip(got, want)):
                assert torch.equal(g, w[c]), (rank, i)


@pytest.mark.parametrize("seq_parallel", (False, True), ids=["sp=False", "sp=True"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_gradients_on_ranks_equal_the_stacked_mesh(ranks, arch, seq_parallel):
    loss, want = _stacked_one_thread(_grads, arch, M.Mesh(SHAPE, NAMES, device="cpu"),
                                     seq_parallel)
    for rank, out in enumerate(ranks):
        got_loss, got = out[("grads", arch, seq_parallel)]
        assert abs(got_loss.item() - loss.item()) <= 1e-6 * abs(loss.item()), rank
        assert sorted(got) == sorted(want)
        for leaf, w in want.items():
            scale = w.abs().max().item()
            assert (got[leaf] - w).abs().max().item() <= 1e-6 * scale, (rank, leaf)
