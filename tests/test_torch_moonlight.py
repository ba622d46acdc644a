"""Moonlight-16B-A3B (MLA, DeepSeek-V3's experts, a dense first layer) in the
port against the plain reference ``tests/moonlight_reference.py``, at a
small size on the CPU in f32 with seeded weights: unsharded and on the
stacked (1, 4) ("data", "model") mesh with sequence parallelism, whose
expert-parallel MoE routes each member's block of the sequence at its own
capacity.

Tolerances: both sides compute in f32 with other orders of summation (the
port's bmm over a capacity buffer, its chunked loss and reduce_nway sums;
the reference's per-expert products and one-hot ranks), so outputs and
losses agree to a few f32 ulps of their size: 2e-5 relative (logits,
gradients) and 1e-5 absolute on O(1) numbers.  Routing is exact (both pick
the top K of the same f32 scores by a stable sort), so no tolerance covers
a routing flip.  After AdamW each element agrees to 5e-3 of the learning
rate: Adam's step ``lr m / (sqrt(v) + eps)`` is of size lr whatever the
gradient, so a gradient near nought, a sum that nearly cancels and so has
a large relative rounding, carries that rounding into a step of full
size (the largest gap seen is 1.6e-3 of lr); each leaf's change agrees to
1e-4 of its norm, and the biases exactly.
"""

import copy
import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

import moonlight_reference as ref
from repro_torch.configs.moonlight_16b_a3b import from_published
from repro_torch.core import mesh as M
from repro_torch.core.mesh import Mesh
from repro_torch.kernels.flash_attention import flash_attention, flash_route
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.launch.steps import make_policy
from repro_torch.models import mla
from repro_torch.models import mlp
from repro_torch.models import transformer as tt
from repro_torch.models.convert import laid_out_specs, shard_model
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig

ROOT = Path(__file__).resolve().parents[1]
CFG = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 4,
       "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16, "kv_lora_rank": 32,
       "q_lora_rank": None, "n_group": 1, "intermediate_size": 128,
       "moe_intermediate_size": 32, "n_routed_experts": 8, "num_experts_per_tok": 3,
       "n_shared_experts": 2, "first_k_dense_replace": 1, "num_hidden_layers": 3,
       "vocab_size": 256, "routed_scaling_factor": 2.446, "rms_norm_eps": 1e-5,
       "rope_theta": 50000.0, "tie_word_embeddings": False, "aux_loss_alpha": 0.01,
       "bias_update_speed": 0.001, "capacity_factor": 1.25}
OPT = {"lr": 1e-2, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1, "grad_clip": 1.0,
       "warmup": 1, "total_steps": 100}
B, S = 2, 32
SEQ = (("data",), "model", None)  # a (B, S, d) activation under sequence parallelism


def port_cfg(cfg=CFG, **kw):
    return from_published(cfg, param_dtype=torch.float32, compute_dtype=torch.float32,
                          remat=False, loss_chunk=8, **kw)


def weights(cfg=CFG, seed=0) -> dict:
    """The port's initial weights by name, with every norm scale drawn too."""
    gen = torch.Generator().manual_seed(seed)
    model = tt.init(gen, port_cfg(cfg), "cpu")
    out = {k: p.detach().clone() for k, p in model.named_parameters()}
    for k, t in out.items():
        if t.ndim == 1:
            t.copy_(0.1 * torch.randn(t.shape, generator=gen))
    return out


def tokens(seed=1):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randint(0, CFG["vocab_size"], (B, S + 1), generator=gen)
    return {"tokens": x[:, :-1], "labels": x[:, 1:]}


def layer_params(w: dict, i: int) -> dict:
    return {k[len(f"blocks.{i}."):]: t for k, t in w.items() if k.startswith(f"blocks.{i}.")}


def group(w: dict, i: int, name: str) -> dict:
    head = f"blocks.{i}.{name}."
    return {k[len(head):]: t for k, t in w.items() if k.startswith(head)}


def mesh_and_policy(cfg):
    mesh = Mesh((1, 4), ("data", "model"), device="cpu")
    return mesh, make_policy(cfg, mesh, seq_parallel=True)


def close(a, b, rel=2e-5):
    return (a - b).abs().max().item() <= rel * max(1.0, b.abs().max().item())


def test_config_holds_the_published_widths():
    from repro_torch.configs import get_config

    c = get_config("moonlight_16b_a3b")
    assert (c.n_layers, c.d_model, c.n_heads, c.vocab) == (27, 2048, 16, 163840)
    assert (c.kv_lora_rank, c.qk_nope_head_dim, c.qk_rope_head_dim, c.v_head_dim) == \
        (512, 128, 64, 128)
    assert (c.n_experts, c.top_k, c.expert_ff, c.shared_ff, c.d_ff) == (64, 6, 1408, 2816, 11264)
    assert (c.first_k_dense, c.router_scoring, c.routed_scaling) == (1, "sigmoid", 2.446)
    # 6 layers: the dense one and 5 MoE layers, as the benchmark's stage
    assert dataclasses.replace(c, n_layers=6).n_params == 3_678_276_608


def test_flash_attention_takes_a_narrower_v():
    gen = torch.Generator().manual_seed(3)
    q, k = (torch.randn(6, 40, 24, generator=gen) for _ in range(2))
    v = torch.randn(6, 40, 16, generator=gen)
    out = flash_attention(q, k, v, window=9)
    assert out.shape == (6, 40, 16)
    s = (q @ k.transpose(1, 2)) / 24 ** 0.5
    i = torch.arange(40)
    live = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - 9)
    want = torch.softmax(s.masked_fill(~live, float("-inf")), -1) @ v
    assert close(out, want)
    with pytest.raises(ValueError, match="dv <= d"):
        flash_attention(v, v, q)
    assert flash_route(torch.bfloat16, 192, (0, 16), 128) == "tensor_core"
    assert flash_route(torch.bfloat16, 192, (0, 8), 128) == "mma_sync"
    assert flash_route(torch.float32, 192, (0, 16), 128) == "mma_sync"
    assert flash_route(torch.bfloat16, 192) == "mma_sync"


def test_flash_attention_gradient_with_a_narrower_v():
    gen = torch.Generator().manual_seed(4)
    q, k = (torch.randn(3, 20, 24, generator=gen, requires_grad=True) for _ in range(2))
    v = torch.randn(3, 20, 16, generator=gen, requires_grad=True)
    g = torch.randn(3, 20, 16, generator=gen)
    got = torch.autograd.grad(flash_attention(q, k, v), (q, k, v), g)
    want = torch.autograd.grad(flash_attention_ref(q, k, v), (q, k, v), g)
    assert all(close(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("sharded", [False, True])
def test_mla_forward_matches_reference(sharded):
    cfg, w = port_cfg(), weights()
    h = torch.randn(B, S, CFG["hidden_size"], generator=torch.Generator().manual_seed(5))
    want = ref.mla(h, layer_params(w, 1), CFG)
    positions = torch.arange(S, dtype=torch.int32)
    if not sharded:
        got = mla.attention(group(w, 1, "attn"), h, positions, cfg)
    else:
        mesh, policy = mesh_and_policy(cfg)
        model = shard_model(tt.from_named(cfg, w), mesh, policy)
        with mesh:
            got = mla.attention(model.blocks[1].attn, M.shard(h, mesh, SEQ), positions, cfg,
                                policy)
        got = M.unshard(got, mesh, SEQ)
    assert close(got, want)


def test_router_choice_follows_the_bias_not_the_gates():
    cfg, w = port_cfg(), weights()
    gen = torch.Generator().manual_seed(6)
    xf = torch.randn(64, CFG["hidden_size"], generator=gen)
    params = group(w, 1, "moe")
    scores = torch.sigmoid(xf @ params["router"])
    plain = torch.sort(scores, dim=-1, descending=True, stable=True)[1][:, :3]
    vals, idx, _ = mlp._route_biased(params, xf, cfg, None)
    assert torch.equal(idx, plain)
    bias = 0.05 * torch.randn(8, generator=gen)
    vals, idx, got_scores = mlp._route_biased(params, xf, cfg, bias)
    _, want_idx, want_gates, _ = ref.route(xf[None], params["router"], bias, CFG)
    assert torch.equal(idx, want_idx[0]) and not torch.equal(idx, plain)
    # the gates are the unbiased scores of the chosen experts, normalised, times 2.446
    assert close(vals, want_gates[0])
    assert close(vals, torch.gather(scores, -1, idx) / torch.gather(scores, -1, idx).sum(
        -1, keepdim=True) * 2.446)
    assert close(vals.sum(-1), torch.full((64,), 2.446))
    # a large bias on expert 5 puts it among every token's choices
    vals, idx, _ = mlp._route_biased(params, xf, cfg, torch.eye(8)[5])
    assert bool((idx == 5).any(-1).all())


def test_moe_layer_with_shared_experts_matches_reference():
    cfg, w = port_cfg(), weights()
    h = torch.randn(B, S, CFG["hidden_size"], generator=torch.Generator().manual_seed(7))
    bias = 0.02 * torch.randn(8, generator=torch.Generator().manual_seed(8))
    want, want_balance, want_loads, _, _ = ref.moe(h, layer_params(w, 2), bias, CFG, members=1)
    tally = {}
    with mlp.tally_loads(tally):
        got, balance = mlp.moe(group(w, 2, "moe"), h, cfg, bias=bias, shared=group(w, 2, "shared"))
    assert close(got, want) and close(balance, want_balance)
    assert torch.equal(tally[id(bias)][1], want_loads)
    # the shared experts alone, with every routed expert's output zero
    silent = dict(group(w, 2, "moe"), w_down=torch.zeros_like(w["blocks.2.moe.w_down"]))
    alone, _ = mlp.moe(silent, h, cfg, bias=bias, shared=group(w, 2, "shared"))
    assert close(alone, mlp.mlp(group(w, 2, "shared"), h, mlp.shared_cfg(cfg)))


def test_dense_first_layer():
    cfg, w = port_cfg(), weights()
    model = tt.from_named(cfg, w)
    first, second = model.blocks[0], model.blocks[1]
    assert first.moe is None and first.shared is None and first.router_bias is None
    assert first.mlp["w_gate"].shape == (64, 128)
    assert second.mlp is None and second.moe["w_gate"].shape == (8, 64, 32)
    assert second.shared["w_gate"].shape == (64, 64) and second.router_bias.shape == (8,)
    x = torch.randn(B, S, CFG["hidden_size"], generator=torch.Generator().manual_seed(9))
    positions = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    got, aux = tt._layer(first, x, positions, 0, cfg)
    want = ref._layer(x, layer_params(w, 0), None, 0, CFG, 1, ref._keep)[0]
    assert close(got, want) and float(aux) == 0.0


def _skewed(w):
    """Weights whose routers send the tokens whose states sum above nought
    to experts 0-2 first: the capacity drops many pairs."""
    w = dict(w)
    for i in (1, 2):
        r = w[f"blocks.{i}.moe.router"].clone()
        r[:, :3] += 3.0
        w[f"blocks.{i}.moe.router"] = r
    return w


def test_capacity_rule_is_per_member():
    """On the (1, 4) mesh each member keeps, for each expert, its own first
    C pairs of its block of the sequence, as the reference with 4 members
    does; one member's rule over the whole batch keeps other pairs."""
    cfg, w = port_cfg(), _skewed(weights())
    h = torch.randn(B, S, CFG["hidden_size"], generator=torch.Generator().manual_seed(10))
    p = layer_params(w, 1)
    bias = torch.zeros(8)
    want4 = ref.moe(h, p, bias, CFG, members=4)[0]
    want1 = ref.moe(h, p, bias, CFG, members=1)[0]
    assert not close(want4, want1)
    mesh, policy = mesh_and_policy(cfg)
    model = shard_model(tt.from_named(cfg, w), mesh, policy)
    blk = model.blocks[1]
    with mesh:
        got, _ = mlp.moe(blk.moe, M.shard(h, mesh, SEQ), cfg, policy, blk.router_bias,
                         blk.shared)
    assert close(M.unshard(got, mesh, SEQ), want4)
    got1, _ = mlp.moe(group(w, 1, "moe"), h, cfg, bias=bias, shared=group(w, 1, "shared"))
    assert close(got1, want1)


def _port_loss_and_grads(cfg, w, batch, sharded: bool):
    model = tt.from_named(cfg, w, trainable=True)
    if not sharded:
        loss = tt.loss_fn(model, batch, cfg)
        names = [k for k, _ in model.named_parameters()]
        grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
        return float(loss.detach()), dict(zip(names, grads))
    mesh, policy = mesh_and_policy(cfg)
    shard_model(model, mesh, policy).requires_grad_(True)
    loss = tt.loss_fn(model, batch, cfg, policy)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    specs = laid_out_specs(model)
    return float(loss.detach()), {k: M.unshard(M.sum_copies(g, mesh, specs[k]), mesh, specs[k])
                         for k, g in zip(params, grads)}


@pytest.mark.parametrize("sharded", [False, True])
def test_loss_and_every_gradient_match_reference(sharded):
    cfg, w, batch = port_cfg(), _skewed(weights()), tokens()
    members = 4 if sharded else 1
    params = {k: t.clone().requires_grad_(True) for k, t in w.items()}
    biases = {i: torch.zeros(8) for i in ref.moe_layers(CFG)}
    want_loss = ref.loss_of(params, biases, batch, CFG, members)[0]
    want = dict(zip(params, torch.autograd.grad(want_loss, list(params.values()))))
    loss, grads = _port_loss_and_grads(cfg, w, batch, sharded)
    want_loss = float(want_loss.detach())
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    assert set(grads) == set(want)
    for k in want:
        assert close(grads[k], want[k]), k


@pytest.mark.parametrize("sharded", [False, True])
def test_adamw_steps_and_bias_update_match_reference(sharded):
    """Two steps (the first at the warm-up's zero rate) through
    ``Trainer.fit``: the losses, the parameters and the selection biases
    after them."""
    cfg, w = port_cfg(), _skewed(weights())
    batches = [tokens(1), tokens(2)]
    members = 4 if sharded else 1
    want = ref.train_readings(CFG, OPT, w, batches, members)
    kw = {}
    if sharded:
        kw["mesh"], kw["policy"] = mesh_and_policy(cfg)
    tcfg = TrainerConfig(adamw=AdamWConfig(lr=OPT["lr"], b1=OPT["b1"], b2=OPT["b2"],
                                           eps=OPT["eps"], weight_decay=OPT["weight_decay"],
                                           grad_clip=OPT["grad_clip"]),
                         warmup=OPT["warmup"], total_steps=OPT["total_steps"])
    trainer = Trainer(cfg, tcfg, model=tt.from_named(cfg, copy.deepcopy(w)), **kw)

    class Feed:
        def batch_at(self, step):
            return {k: v.numpy() for k, v in batches[step].items()}

    model, _ = trainer.fit(Feed(), steps=2)
    losses = [r["loss"] for r in trainer.metrics_log]
    assert all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(losses, want["losses"]))
    got = {k: p.detach() for k, p in model.named_parameters()}
    if sharded:
        specs = laid_out_specs(model)
        got = {k: M.unshard(t, model.mesh, specs[k]) for k, t in got.items()}
    assert set(got) == set(want["params"])
    for k, t in got.items():
        assert (t - w[k]).abs().max().item() > 0, k  # the second step moved every leaf
        assert (t - want["params"][k]).abs().max().item() <= 5e-3 * OPT["lr"], k
        change = float(torch.linalg.vector_norm(t - w[k]))
        assert abs(change - want["change_norms"][k]) <= 1e-4 * want["change_norms"][k], k
    for i, blk in enumerate(model.blocks):
        if blk.router_bias is not None:
            assert torch.equal(blk.router_bias, want["biases"][i])
            assert bool((blk.router_bias != 0).any())


def test_reference_copies_agree():
    """The tests' reference is ``portbench/reference/moonlight.py`` (the
    benchmark's), one file: loaded apart by its path it gives the same
    readings on the same tiny model, and every compared gap reads nought."""
    bench_file = ROOT / "portbench" / "reference" / "moonlight.py"
    assert Path(ref.__file__).resolve() == bench_file
    spec = importlib.util.spec_from_file_location("portbench_moonlight_copy", bench_file)
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    w, batches = weights(), [tokens(1), tokens(2)]
    a = ref.train_readings(CFG, OPT, w, batches, members=4)
    b = bench.train_readings(CFG, OPT, w, batches, members=4)
    assert a["losses"] == b["losses"] and a["grad_norms"] == b["grad_norms"]
    assert a["change_norms"] == b["change_norms"]
    assert all(torch.equal(a["biases"][i], b["biases"][i]) for i in a["biases"])
    assert bench.compare(b, a) == {"loss_gap": 0.0, "grad_gap": 0.0, "change_gap": 0.0,
                                   "route_gap": 0.0, "bias_gap": 0.0}


def test_pin_takes_the_other_runs_choice_only_at_a_near_tie():
    # token 0: the other run swapped the 3rd and 4th experts, 0.01 apart;
    # token 1: it chose expert 3, 0.2 below the reference's 3rd choice
    choice = torch.tensor([[0.90, 0.80, 0.70, 0.69, 0.10],
                           [0.90, 0.80, 0.70, 0.50, 0.10]])
    idx = torch.tensor([[0, 1, 2], [0, 1, 2]])
    theirs = torch.tensor([[1, 0, 3], [0, 1, 3]])
    got, tally = ref.pin(choice, idx, theirs, margin=0.05)
    assert got.tolist() == [[1, 0, 3], [0, 1, 2]]
    assert tally.tolist() == pytest.approx([2, 1, 0.2])  # differ, pinned, farthest
    got, tally = ref.pin(choice, idx, theirs, margin=0.005)
    assert got.tolist() == idx.tolist() and tally.tolist()[:2] == [2, 0]
    got, tally = ref.pin(choice, idx, torch.tensor([[2, 1, 0], [1, 2, 0]]), margin=0.05)
    assert tally.tolist() == [0, 0, 0]  # the same sets in another order


def test_compare_reads_the_routing_and_the_biases():
    """``route_gap`` is the worst step's share of (token, MoE layer) pairs
    routed to another set than the reference's own, pinned or not;
    ``bias_gap`` the biases' mean gap over every MoE layer's experts, in
    units of the rate."""
    w, batches = weights(), [tokens(1), tokens(2)]
    want = ref.train_readings(CFG, OPT, w, batches, members=4)
    got = copy.deepcopy(want)
    assert ref.compare(got, want)["bias_gap"] == 0.0
    got["biases"][1] = got["biases"][1] + torch.tensor([2e-3] + [0.0] * 7)
    got["biases"][2] = got["biases"][2] - 1e-3
    assert ref.compare(got, want)["bias_gap"] == pytest.approx((2 + 8) / 16, rel=1e-5)
    # the other run routes the last MoE layer's first step by score alone
    theirs = [dict(c) for c in want["choices"]]
    flipped = theirs[0][2].clone()
    flipped[0, 0] = torch.tensor([7, 6, 5])
    theirs[0][2] = flipped
    pinned = ref.train_readings(CFG, OPT, w, batches, members=4, pinned=theirs)
    differ = (torch.sort(flipped, -1)[0] != torch.sort(want["choices"][0][2], -1)[0]).any(-1)
    assert pinned["routing"][0]["differing"] == int(differ.sum()) == 1
    assert ref.compare(got, pinned)["route_gap"] == pytest.approx(1 / (B * S * 2))


def test_recorded_choices_pin_the_reference_to_the_program():
    """The port's recorded routing (``mlp.record_choices``: one gate_idx a
    MoE forward, none from a remat recompute) laid out as the reference's
    (B, S, K), and the reference pinned to it: a bf16 port at the small
    size settles some near-ties its own way, and the pinned reference then
    routes exactly as the port did."""
    cfg = dataclasses.replace(port_cfg(), remat=True)
    w, batch = weights(), tokens()
    mesh, policy = mesh_and_policy(cfg)
    model = shard_model(tt.from_named(cfg, w), mesh, policy).requires_grad_(True)
    rec = []
    with mlp.record_choices(rec):
        loss = tt.loss_fn(model, batch, cfg, policy)
    torch.autograd.grad(loss, list(model.parameters()))  # the recompute records nothing
    assert len(rec) == CFG["num_hidden_layers"] - CFG["first_k_dense_replace"]
    assert rec[0].shape == (1, 4, B * S // 4, 3) and rec[0].dtype == torch.int16
    glob = [t.reshape(1, 4, B, S // 4, 3).permute(0, 2, 1, 3, 4).reshape(B, S, 3) for t in rec]
    params = {k: t.clone() for k, t in w.items()}
    biases = {i: torch.zeros(8) for i in ref.moe_layers(CFG)}
    _, _, choices, tally = ref.loss_of(params, biases, batch, CFG, 4,
                                       pinned=dict(zip(ref.moe_layers(CFG), glob)))
    for i, t in zip(ref.moe_layers(CFG), glob):
        assert torch.equal(torch.sort(choices[i], -1)[0], torch.sort(t.long(), -1)[0])
    assert all(int(n[0]) == 0 for n in tally.values())  # f32 both: no flips to settle
