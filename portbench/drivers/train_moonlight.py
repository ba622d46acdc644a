"""The training driver of Moonlight-16B-A3B (DeepSeek-V3's architecture):
``repro_torch.runtime.trainer.Trainer.fit`` on a sharding policy over a
stacked mesh, fed by the benchmark's token stream, as ``drivers/train.py``
runs a dense model.

Configuration keys: the published ``config.json`` keys of a deepseek_v3
model (``reference/moonlight.py:widths``), ``aux_loss_alpha``,
``bias_update_speed``, ``capacity_factor``, ``torch_dtype`` (weights and
products; the router and the loss head stay f32), ``remat``, ``mesh`` and
``mesh_axes``.  Traffic keys: those of ``drivers/train.py``.

The window opens and closes as in ``drivers/train.py`` (the feed stamps
the host's clock and ends ``fit`` by raising ``WindowClosed``), and the
trainer is observed at its step in the same way: each checked step's loss,
each parameter's first gradient (AdamW's first moment over 1 - b1, after
one step) and its change over the checked steps, as global norms,
its routers' choices in the checked steps (``mlp.record_choices``) and
its selection biases after them.  Once the program's state is freed,
``reference/moonlight.py`` follows the checked steps from the same weights
and rows, its capacity rule over the mesh's model axis (the members that
share each layer), AdamW's moments on the host, the program's choices
taken at near-ties (its ``pin``).  The run compares the gaps that the
traffic's ``limits`` name (``compare``'s numbers), and keeps the
reference's routing tally as ``Run.routing``.  A traced run also reads the program's own spans
(``program_spans.collect``, as ``Trace.program``) and, once after the
window, its counters (``repro_torch.tracing.counters``, as
``Run.counters``); a program without them gives an empty ``Program`` and
no counters.
"""

from __future__ import annotations

import contextlib
import gc
import statistics
import sys
import time

from portbench.drivers.train import WindowClosed


def moonlight_weights(cfg: dict, seed: int, device, dtype) -> dict:
    """Every weight by the program's parameter name, drawn from a generator
    on ``device`` seeded with ``seed``, one draw a kind of weight (stacked
    over the layers that hold it), as ``inputs.llama_weights`` draws a dense
    model's: products N(0, 1 / fan_in) in ``dtype`` (the router in f32),
    the embedding and the head N(0, 0.02^2), the norm scales zero (they
    scale by 1 + scale)."""
    import torch

    from portbench.reference.moonlight import moe_layers, widths

    w = widths(cfg)
    d, H, r, V = w["d"], w["H"], w["r"], w["V"]
    qk, kv = w["nope"] + w["rope"], w["nope"] + w["vd"]
    fs = cfg["n_shared_experts"] * w["fe"]
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))

    def draw(shape, std, dt=dtype):
        return torch.randn(shape, generator=gen, device=device).mul_(std).to(dt)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    every, dense, moe = range(w["L"]), range(w["dense"]), moe_layers(cfg)
    kinds = [
        (every, "attn.wq", lambda n: draw((n, d, H * qk), d ** -0.5)),
        (every, "attn.wkv_a", lambda n: draw((n, d, r + w["rope"]), d ** -0.5)),
        (every, "attn.kv_norm", lambda n: zeros((n, r))),
        (every, "attn.wkv_b", lambda n: draw((n, r, H * kv), r ** -0.5)),
        (every, "attn.wo", lambda n: draw((n, H * w["vd"], d), (H * w["vd"]) ** -0.5)),
        (dense, "mlp.w_gate", lambda n: draw((n, d, w["f"]), d ** -0.5)),
        (dense, "mlp.w_up", lambda n: draw((n, d, w["f"]), d ** -0.5)),
        (dense, "mlp.w_down", lambda n: draw((n, w["f"], d), w["f"] ** -0.5)),
        (moe, "moe.router", lambda n: draw((n, d, w["E"]), d ** -0.5, torch.float32)),
        (moe, "moe.w_gate", lambda n: draw((n, w["E"], d, w["fe"]), d ** -0.5)),
        (moe, "moe.w_up", lambda n: draw((n, w["E"], d, w["fe"]), d ** -0.5)),
        (moe, "moe.w_down", lambda n: draw((n, w["E"], w["fe"], d), w["fe"] ** -0.5)),
        (moe, "shared.w_gate", lambda n: draw((n, d, fs), d ** -0.5)),
        (moe, "shared.w_up", lambda n: draw((n, d, fs), d ** -0.5)),
        (moe, "shared.w_down", lambda n: draw((n, fs, d), fs ** -0.5)),
        (every, "norm1", lambda n: zeros((n, d))),
        (every, "norm2", lambda n: zeros((n, d))),
    ]
    out = {"embed": draw((V, d), 0.02)}
    for layers, key, make in kinds:
        if len(layers):
            for i, t in zip(layers, make(len(layers))):
                out[f"blocks.{i}.{key}"] = t
    out["final_norm"] = zeros((d,))
    out["lm_head"] = draw((V, d), 0.02)
    return out


def global_choices(t, B: int, S: int):
    """A stacked (data, model) mesh's routing choices (nd, nm, T, K), each
    member's tokens its rows' block of S in (row, position) order, as the
    global (B, S, K) on the host."""
    nd, nm, _, K = t.shape
    return t.reshape(nd, nm, B // nd, S // nm, K).permute(0, 2, 1, 3, 4).reshape(B, S, K).cpu()


def model_config(cfg: dict):
    """The program's ``ModelConfig`` from the configuration's published keys."""
    import torch

    from repro_torch.configs.moonlight_16b_a3b import from_published

    dtype = getattr(torch, cfg["torch_dtype"])
    return from_published(cfg, param_dtype=dtype, compute_dtype=dtype, remat=cfg["remat"])


def run(cell, seed: int, seconds: float, trace: bool, device: str, started: float):
    import torch

    from portbench import inputs, program_spans
    from portbench import trace as T
    from portbench.cell import Run
    from portbench.reference import moonlight
    from repro_torch import tracing
    from repro_torch.core import mesh as M
    from repro_torch.core.mesh import Mesh
    from repro_torch.launch.steps import make_policy
    from repro_torch.models import mlp
    from repro_torch.models import transformer as tt
    from repro_torch.models.convert import laid_out_specs
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    stamps = [("start", started), ("imports", time.perf_counter())]
    cfg, tr = cell.config, cell.traffic
    B, S, V = tr["batch"], tr["seq"], cfg["vocab_size"]
    checked, warm, opt = tr["checked_steps"], tr["warm_steps"], tr["optimizer"]
    dtype = getattr(torch, cfg["torch_dtype"])
    spans = T.Spans(trace)
    mcfg = model_config(cfg)
    weights = moonlight_weights(cfg, seed, device, dtype)
    sync()
    stamps.append(("weights", time.perf_counter()))
    mesh = Mesh(tuple(cfg["mesh"]), tuple(cfg["mesh_axes"]), device=device)
    tcfg = TrainerConfig(adamw=AdamWConfig(lr=opt["lr"], b1=opt["b1"], b2=opt["b2"],
                                           eps=opt["eps"], weight_decay=opt["weight_decay"],
                                           grad_clip=opt["grad_clip"]),
                         warmup=opt["warmup"], total_steps=opt["total_steps"])
    seen = {"losses": [], "grad_norms": {}, "change_norms": {}, "biases": {}}
    choices = []  # the program's routing of each checked step, by MoE layer

    def global_norms(model, tensors: dict) -> dict:
        specs = laid_out_specs(model)
        return {k: M.unshard(t, mesh, specs[k]) for k, t in tensors.items()}

    class Observed(Trainer):
        steps = 0

        def _step_fn(self, model, opt_state, batch, err_state):
            i, self.steps = self.steps, self.steps + 1
            record = mlp.record_choices([]) if i < checked else contextlib.nullcontext()
            with spans.span("step"), record as rec:
                out = super()._step_fn(model, opt_state, batch, err_state)
            if i < checked:
                seen["losses"].append(float(out[3]["loss"]))
                choices.append({layer: global_choices(t, B, S) for layer, t in
                                zip(moonlight.moe_layers(cfg), rec)})
            with torch.no_grad():
                if i == 0:
                    for k, t in out[1]["m"].items():
                        g = global_norms(model, {k: t})[k]
                        seen["grad_norms"][k] = float(torch.linalg.vector_norm(g)) / (1 - opt["b1"])
                if i == checked - 1:
                    for k, p in model.named_parameters():
                        now = global_norms(model, {k: p.detach()})[k].float()
                        seen["change_norms"][k] = float(
                            torch.linalg.vector_norm(now - weights[k].float()))
                    for layer in moonlight.moe_layers(cfg):
                        seen["biases"][layer] = model.blocks[layer].router_bias.to(
                            "cpu", torch.float32, copy=True)
            return out

    clock = {}

    class Feed:
        def batch_at(self, step: int) -> dict:
            if step <= warm:
                stamps.append((f"step {step - 1}" if step else "trainer", time.perf_counter()))
            if step == warm:
                sync()
                print("portbench set-up s: " + ", ".join(
                    f"{b[0]} {b[1] - a[1]:.3f}" for a, b in zip(stamps, stamps[1:])),
                    file=sys.stderr, flush=True)
                clock["prof"] = T.start_profiler() if trace else None
                clock["open"] = time.perf_counter()
            elif step > warm and time.perf_counter() - clock["open"] >= seconds:
                clock["close"], clock["steps"] = time.perf_counter(), step - warm
                if clock["prof"] is not None:
                    clock["prof"].stop()
                raise WindowClosed
            with spans.span("feed"):
                return inputs.token_batch(seed, step, B, S, V)

    trainer = Observed(mcfg, tcfg, model=tt.from_named(mcfg, weights), mesh=mesh,
                       policy=make_policy(mcfg, mesh, seq_parallel=tr["seq_parallel"]))
    try:
        trainer.fit(Feed(), steps=1 << 62, seed=seed)
    except WindowClosed:
        pass
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    counters = None
    if clock["prof"] is not None and hasattr(tracing, "counters"):
        counters = tracing.counters()
        tracing.reset_counters()
    del trainer, weights
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    traced = None
    if clock["prof"] is not None:
        traced = T.reduce_profile(clock["prof"])
        traced.program = program_spans.collect(clock["prof"])
    clock.pop("prof")

    batches = [{k: torch.from_numpy(v).to(device)
                for k, v in inputs.token_batch(seed, s, B, S, V).items()} for s in range(checked)]
    members = cfg["mesh"][cfg["mesh_axes"].index("model")]
    pinned = [{k: t.to(device) for k, t in c.items()} for c in choices]
    ref = moonlight.train_readings(cfg, opt, moonlight_weights(cfg, seed, device, dtype), batches,
                                   members, moments_device="cpu", pinned=pinned)
    print(f"portbench routing against the reference, by step (of {B * S} tokens a layer): "
          f"{ref['routing']}", file=sys.stderr, flush=True)
    gaps = moonlight.compare(seen, ref)
    print(f"portbench gaps: {gaps}", file=sys.stderr, flush=True)
    leaves = moonlight.counted(ref["grad_norms"])
    for part in ("grad_norms", "change_norms"):  # the leaf that sets each gap, for the log
        med = statistics.median(ref[part][k] for k in leaves)
        k = max(leaves, key=lambda k: abs(seen[part][k] - ref[part][k]) / max(ref[part][k], med))
        print(f"portbench {part} farthest leaf: {k} {seen[part][k]!r} against {ref[part][k]!r}",
              file=sys.stderr, flush=True)
    ref_routing = ref["routing"]
    del ref
    window_s, steps = clock["close"] - clock["open"], clock["steps"]
    out = Run(
        setup_s=clock["open"] - started, window_s=window_s, units=steps, attempted=steps,
        end_to_end={"train_tokens_per_s": steps * B * S / window_s if window_s > 0 else 0.0,
                    "setup_s": clock["open"] - started},
        checks={k: (gaps[k], limit) for k, limit in tr["limits"].items()},
        shapes={"config": cfg, "batch": B, "seq": S},
        device_kind=torch.cuda.get_device_name(0) if cuda else "cpu",
        memory_peak_bytes=int(peak), trace=traced)
    out.counters, out.routing = counters, ref_routing
    return out
