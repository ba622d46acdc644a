"""The port's spans (``repro_torch/tracing.py``) under a CPU ``torch.profiler``.

Spans carry their ``rt:`` names and nest: the collectives inside SUMMA's and
FCL's entry spans, the mesh's inside the schedules'.  A region's backward
span opens with its first output gradient and closes after its last input
gradient, so that its backward's operations, the remat recompute included,
lie inside it.  With no profiler the spans are off: SUMMA, FCL and a tiny
sharded training step on a stacked (2, 2) CPU mesh give the same bits as a
traced run, and an untraced graph holds no node of the regions.  The flag
that switches them, ``torch.autograd.profiler._is_profiler_enabled``, is
pinned to a profiler's start and stop, so that a PyTorch that drops it
fails here rather than silently turning the spans off.
"""

import copy
import dataclasses
import inspect

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile
from torch.utils.checkpoint import checkpoint

from repro_torch import tracing
from repro_torch.configs import get_smoke_config
from repro_torch.core import mesh as M
from repro_torch.core.fcl import fcl_sharded
from repro_torch.core.summa import summa_sharded
from repro_torch.launch.steps import make_policy
from repro_torch.models import transformer as tt
from repro_torch.models.convert import shard_model
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig

SHAPE, NAMES = (2, 2), ("data", "model")


def _events(prof):
    """(name, start, end, thread) of every host event, in start order."""
    out = [(e.name(), e.start_ns(), e.end_ns(), e.device_resource_id())
           for e in prof.profiler.kineto_results.events()]
    return sorted(out, key=lambda r: r[1])


def _spans(events, name=None):
    return [e for e in events if e[0].startswith(tracing.PREFIX)
            and (name is None or e[0] == tracing.PREFIX + name)]


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2] and inner[3] == outer[3]


def _traced(fn):
    """``fn()`` under a CPU profiler: (its result, the host events)."""
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        out = fn()
    finally:
        prof.stop()
    return out, _events(prof)


def _operands(m=8, k=8, n=12, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(m, k, generator=gen), torch.randn(k, n, generator=gen)


def test_profiler_flag_flips_with_a_profiler():
    assert autograd_profiler._is_profiler_enabled is False
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        assert autograd_profiler._is_profiler_enabled is True
        assert isinstance(tracing.span("x"), torch._C._profiler._RecordFunctionFast)
    finally:
        prof.stop()
    assert autograd_profiler._is_profiler_enabled is False
    assert tracing.span("x") is tracing.span("y")  # one shared context, nothing made


@pytest.mark.parametrize("schedule", ["native", "ring", "tree"])
def test_summa_spans_nest_in_the_entry_span(schedule):
    a, b = _operands()
    mesh = M.Mesh((2, 2), ("row", "col"), device="cpu")
    _, events = _traced(lambda: summa_sharded(a, b, mesh, "row", "col", schedule=schedule))
    (entry,) = _spans(events, "summa")
    collectives = [s for s in _spans(events) if s[0] != "rt:summa"]
    assert collectives and all(s[0].startswith("rt:collective.") for s in collectives)
    assert all(_inside(s, entry) for s in collectives)
    names = {s[0] for s in collectives}
    if schedule == "ring":
        assert names == {"rt:collective.rotate_by", "rt:collective.ppermute"}
        for p in _spans(events, "collective.rotate_by"):
            assert any(_inside(q, p) for q in _spans(events, "collective.ppermute"))
    else:
        assert "rt:collective.broadcast" in names
        inner = {"native": "collective.psum", "tree": "collective.ppermute"}[schedule]
        for bc in _spans(events, "collective.broadcast"):
            assert any(_inside(q, bc) for q in _spans(events, inner))
    # the products and the shard copies lie in the entry span, outside the collectives
    ops = [e for e in events if e[0] == "aten::copy_" and _inside(e, entry)]
    assert any(not any(_inside(op, s) for s in collectives) for op in ops)


@pytest.mark.parametrize("scatter", [False, True])
def test_fcl_spans_nest_in_the_entry_span(scatter):
    a, b = _operands(m=8, k=8, n=8)
    mesh = M.Mesh((4,), ("model",), device="cpu")
    _, events = _traced(lambda: fcl_sharded(a, b, mesh, "model", scatter=scatter))
    (entry,) = _spans(events, "fcl")
    outer, inner = (("reduce_scatter", "psum_scatter") if scatter else ("all_reduce", "psum"))
    (sched,) = _spans(events, "collective." + outer)
    (mesh_span,) = _spans(events, "collective." + inner)
    assert _inside(sched, entry) and _inside(mesh_span, sched)


def test_region_backward_span_covers_its_backward_and_recompute():
    w = torch.randn(6, 6, requires_grad=True)
    x = torch.randn(4, 6, requires_grad=True)

    def body(t):
        y = checkpoint(lambda u: torch.tanh(u @ w), t, use_reentrant=False)
        return y.sum(-1), y

    def step():
        first, second = tracing.region("blk", body, x)
        torch.autograd.grad(first.sum() + second.pow(2).sum(), (x, w))

    _, events = _traced(step)
    (fwd,) = _spans(events, "blk")
    (bwd,) = _spans(events, "blk.backward")
    assert fwd[2] <= bwd[1]
    tanh = [e for e in events if e[0] == "aten::tanh"]
    assert len(tanh) == 2  # the forward and the remat recompute
    assert _inside(tanh[0], fwd) and _inside(tanh[1], bwd)
    names = ("TanhBackward0", "MmBackward0", "aten::tanh_backward")
    inner = [e for e in events if e[0] in names]
    assert len(inner) == 3 and all(_inside(e, bwd) for e in inner)
    # the gradient of the outputs (outside the region) comes before it
    assert all(e[2] <= bwd[1] for e in events if e[0] == "PowBackward0")


def test_region_without_a_gradient_is_its_forward_span():
    x = torch.randn(3, 3)
    out, events = _traced(lambda: tracing.region("blk", torch.tanh, x))
    assert out.grad_fn is None and torch.equal(out, torch.tanh(x))
    assert [s[0] for s in _spans(events)] == ["rt:blk"]
    with torch.no_grad():
        y = torch.randn(3, 3, requires_grad=True)
        out, events = _traced(lambda: tracing.region("blk", torch.tanh, y))
    assert out.grad_fn is None


def _tiny_cfg():
    cfg = get_smoke_config("qwen1_5_0_5b")
    return dataclasses.replace(cfg, n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
                               head_dim=16, d_ff=64, vocab=64, loss_chunk=4, remat=True)


def _batch(cfg, seed=0, B=4, S=8):
    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen)
    return {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}


def _nodes(t) -> list:
    """Every autograd node's name in the graph behind ``t``."""
    seen, todo, out = set(), [t.grad_fn], []
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        out.append(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    return out


def _sharded(cfg):
    model = tt.init(torch.Generator().manual_seed(0), cfg, "cpu", trainable=True)
    mesh = M.Mesh(SHAPE, NAMES, device="cpu")
    policy = make_policy(cfg, mesh, seq_parallel=True)
    return shard_model(copy.deepcopy(model), mesh, policy).requires_grad_(True), policy


def test_sharded_loss_traced_is_bit_identical_and_untraced_adds_no_node():
    cfg = _tiny_cfg()
    model, policy = _sharded(cfg)
    batch = _batch(cfg)
    params = list(model.parameters())

    def loss_and_grads():
        loss = tt.loss_fn(model, batch, cfg, policy)
        return loss, _nodes(loss), torch.autograd.grad(loss, params)

    plain_loss, plain_nodes, plain_grads = loss_and_grads()
    (loss, nodes, grads), events = _traced(loss_and_grads)
    assert torch.equal(loss, plain_loss)
    assert all(torch.equal(g, h) for g, h in zip(grads, plain_grads))
    assert "_MarkBackward" not in plain_nodes
    # traced: an input and an output node for each of the two regions, nothing else
    assert sorted(nodes) == sorted(plain_nodes + ["_MarkBackward"] * 4)
    for name in ("blocks", "loss_head"):
        (fwd,) = _spans(events, name)
        (bwd,) = _spans(events, name + ".backward")
        assert fwd[2] <= bwd[1]
    # the layers' remat recomputes run their collectives again inside the backward
    (bwd,) = _spans(events, "blocks.backward")
    assert any(_inside(s, bwd) for s in _spans(events, "collective.all_gather"))
    (head_bwd,) = _spans(events, "loss_head.backward")
    assert any(_inside(s, head_bwd) for s in _spans(events, "collective.pmax"))
    assert head_bwd[2] <= bwd[1]  # the head's backward ends before the layers' starts


class _Batches:
    def __init__(self, cfg):
        self.cfg = cfg

    def batch_at(self, step: int) -> dict:
        return {k: v.numpy() for k, v in _batch(self.cfg, seed=step).items()}


def _trainer(cfg):
    model = tt.init(torch.Generator().manual_seed(0), cfg, "cpu")
    mesh = M.Mesh(SHAPE, NAMES, device="cpu")
    tcfg = TrainerConfig(adamw=AdamWConfig(lr=1e-3), warmup=1, total_steps=10)
    return Trainer(cfg, tcfg, model=model, mesh=mesh,
                   policy=make_policy(cfg, mesh, seq_parallel=True))


def test_sharded_training_step_traced_is_bit_identical():
    cfg = _tiny_cfg()
    plain = _trainer(cfg)
    plain.fit(_Batches(cfg), steps=2)
    traced = _trainer(cfg)
    _, events = _traced(lambda: traced.fit(_Batches(cfg), steps=2))
    for (k, p), (j, q) in zip(plain.state[0].named_parameters(),
                              traced.state[0].named_parameters()):
        assert k == j and torch.equal(p, q), k
    for part in ("m", "v"):
        for k, t in plain.state[1][part].items():
            assert torch.equal(t, traced.state[1][part][k]), (part, k)
    np.testing.assert_array_equal([r["loss"] for r in plain.metrics_log],
                                  [r["loss"] for r in traced.metrics_log])
    assert len(_spans(events, "optimizer")) == 2
    assert len(_spans(events, "collective.sum_copies")) > 0


def test_fit_calls_step_fn_once_a_step():
    """A subclass that observes ``_step_fn`` (the benchmark's training
    driver) relies on its name, its signature and one call a step."""
    params = list(inspect.signature(Trainer._step_fn).parameters)
    assert params == ["self", "model", "opt_state", "batch", "err_state"]
    cfg = _tiny_cfg()
    calls = []

    class Observed(Trainer):
        def _step_fn(self, model, opt_state, batch, err_state):
            out = super()._step_fn(model, opt_state, batch, err_state)
            calls.append((int(opt_state["step"]), float(out[3]["loss"])))
            return out

    trainer = Observed(cfg, TrainerConfig(adamw=AdamWConfig(lr=1e-3)), device="cpu")
    trainer.fit(_Batches(cfg), steps=3)
    assert [step for step, _ in calls] == [0, 1, 2]  # the optimizer step each call starts at
    assert [loss for _, loss in calls] == [r["loss"] for r in trainer.metrics_log]


# -- Moonlight's regions (mla, moe) and the MoE's counters ---------------------


def _moonlight_cfg(remat=False):
    return dataclasses.replace(get_smoke_config("moonlight_16b_a3b"), remat=remat, loss_chunk=4)


def test_mla_and_moe_regions_span_a_profiled_step():
    """Each layer's MLA and each MoE layer's MoE is a region: its forward
    span, and its backward span after the forward, in a profiled sharded
    step (the expert-parallel exchange inside the MoE's forward)."""
    cfg = _moonlight_cfg()
    model, policy = _sharded(cfg)
    batch = _batch(cfg)
    params = list(model.parameters())

    def step():
        loss = tt.loss_fn(model, batch, cfg, policy)
        return torch.autograd.grad(loss, params)

    _, events = _traced(step)
    mla, moe = _spans(events, "mla"), _spans(events, "moe")
    assert len(mla) == cfg.n_layers and len(_spans(events, "mla.backward")) == cfg.n_layers
    assert len(moe) == cfg.n_layers - cfg.first_k_dense == len(_spans(events, "moe.backward"))
    for fwd, bwd in ((mla[-1], _spans(events, "mla.backward")[0]),
                     (moe[-1], _spans(events, "moe.backward")[0])):
        assert fwd[2] <= bwd[1]
    exchanges = _spans(events, "collective.all_to_all")
    assert len(exchanges) == 2 * len(moe)  # dispatch and combine
    assert all(any(_inside(x, m) for m in moe) for x in exchanges)


def _skewed_moe(cfg, seed=0):
    """One MoE layer's weights whose router sends tokens whose states sum
    well above nought to experts 0-2 first, so that capacity drops pairs."""
    model = tt.init(torch.Generator().manual_seed(seed), cfg, "cpu")
    blk = model.blocks[1]
    params = {k: p.detach().clone() for k, p in blk.moe.items()}
    params["router"][:, :3] += 3.0
    shared = {k: p.detach().clone() for k, p in blk.shared.items()}
    return params, shared


def test_counters_count_routed_and_dropped_pairs():
    """Under a profiler the MoE counts its (token, choice) pairs and those that
    capacity drops, once a forward: the remat recompute in the backward is
    not counted again.  The dropped pairs are counted apart, by the plain
    reference's capacity rule.  Without a profiler nothing is counted."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import moonlight_reference as ref

    from repro_torch.models import mlp

    cfg = _moonlight_cfg()
    params, shared = _skewed_moe(cfg)
    B, S, E, K = 2, 24, cfg.n_experts, cfg.top_k
    h = (torch.randn(B, S, cfg.d_model, generator=torch.Generator().manual_seed(3))
         + 1.0).requires_grad_(True)
    bias = torch.zeros(E)

    def step():
        out = checkpoint(lambda x: mlp.moe(params, x, cfg, bias=bias, shared=shared)[0], h,
                         use_reentrant=False)
        return torch.autograd.grad(out.sum(), h)

    tracing.reset_counters()
    step()
    assert tracing.counters() == {}
    _traced(step)
    counts = tracing.counters()
    tracing.reset_counters()
    _, idx, _, _ = ref.route(h.detach(), params["router"], bias, {"num_experts_per_tok": K,
                                                               "routed_scaling_factor": 1.0})
    C = ref.capacity({"n_routed_experts": E, "num_experts_per_tok": K,
                      "capacity_factor": cfg.capacity_factor}, B * S)
    dropped = int((~ref.kept(idx.reshape(-1, K), E, C)).sum())
    assert dropped >= B * S * K // 3  # experts 0-2 take every token, keep C each
    assert counts == {"moe.routed_pairs": B * S * K, "moe.dropped_pairs": dropped}


class _Ops(torch.utils._python_dispatch.TorchDispatchMode):
    """The aten operations that run while the mode is on, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_untraced_moonlight_step_runs_the_same_operations_as_without_regions(monkeypatch):
    """With no profiler the regions, spans and counters run nothing: a
    sharded Moonlight step (remat on) runs the same aten operations, in the
    same order, as with ``tracing.region`` calling its function bare."""
    cfg = _moonlight_cfg(remat=True)

    def ops_of_a_step():
        model, policy = _sharded(cfg)
        params = list(model.parameters())
        with _Ops() as mode:
            loss = tt.loss_fn(model, _batch(cfg), cfg, policy)
            torch.autograd.grad(loss, params)
        return mode.ops

    with_regions = ops_of_a_step()
    monkeypatch.setattr(tracing, "region", lambda name, fn, *args: fn(*args))
    assert ops_of_a_step() == with_regions
    assert len(with_regions) > 1000
