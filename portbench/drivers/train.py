"""The training driver: ``repro_torch.runtime.trainer.Trainer.fit`` on a
sharding policy over a stacked mesh, fed by the benchmark's token stream.

Configuration keys: the model's published widths (``inputs.widths``),
``rope_theta``, ``rms_norm_eps``, ``tie_word_embeddings``, ``torch_dtype``
(weights and products), ``remat``, ``mesh`` and ``mesh_axes``.  Traffic
keys: ``batch`` and ``seq`` (global rows and tokens a step), ``seq_parallel``,
``checked_steps`` (the first steps, which the reference follows),
``warm_steps`` (the window opens before this step), ``optimizer``,
``limits``.

One ``fit`` call runs set-up and window on one trainer: ``fit`` builds its
state anew on every call, so the feed stamps the host's clock, opening the
window as it hands out step ``warm_steps`` and, once ``seconds`` have
passed, closing it as it is asked for the next step (the trainer waits for
each step's loss, so every step before it has ended) by raising
``WindowClosed`` out of ``fit``.  The trainer is observed at its step
(``_step_fn``): the loss of each checked step, each parameter's first
gradient as AdamW takes it (its first moment over 1 - b1, after one step),
and each parameter's change over the checked steps, as global norms.
Once the window has closed and the program's state is freed, the
reference follows the checked steps from the same weights and rows.
"""

from __future__ import annotations

import gc
import sys
import time


class WindowClosed(Exception):
    """Raised by the feed to end ``fit`` when the window's time is up."""


def model_config(cfg: dict):
    """The program's ``ModelConfig`` from the configuration's published keys."""
    import torch

    from portbench.inputs import widths
    from repro_torch.models.common import ModelConfig

    w = widths(cfg)
    dtype = getattr(torch, cfg["torch_dtype"])
    return ModelConfig(name=cfg.get("name", "dense"), family="transformer", n_layers=w["L"],
                       d_model=w["d"], n_heads=w["h"], n_kv_heads=w["kv"], head_dim=w["hd"],
                       d_ff=w["f"], vocab=w["V"], rope_theta=cfg["rope_theta"],
                       norm_eps=cfg["rms_norm_eps"], tie_embeddings=cfg["tie_word_embeddings"],
                       remat=cfg["remat"], param_dtype=dtype, compute_dtype=dtype)


def build_model(mcfg, weights: dict):
    """The program's model holding ``weights`` (by parameter name)."""
    from repro_torch.models.transformer import Block, Transformer

    blocks = [Block(weights[f"blocks.{i}.norm1"], weights[f"blocks.{i}.norm2"],
                    attn={k: weights[f"blocks.{i}.attn.{k}"] for k in ("wq", "wk", "wv", "wo")},
                    mlp={k: weights[f"blocks.{i}.mlp.{k}"] for k in ("w_gate", "w_up", "w_down")})
              for i in range(mcfg.n_layers)]
    return Transformer(mcfg, weights["embed"], blocks, weights["final_norm"],
                       None if mcfg.tie_embeddings else weights["lm_head"])


def run(cell, seed: int, seconds: float, trace: bool, device: str, started: float):
    import torch

    from portbench import inputs
    from portbench import trace as T
    from portbench.cell import Run
    from portbench.reference import llama
    from repro_torch.core import mesh as M
    from repro_torch.core.mesh import Mesh
    from repro_torch.launch.steps import make_policy
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
    weights = inputs.llama_weights(cfg, seed, device, dtype)
    sync()
    stamps.append(("weights", time.perf_counter()))
    mesh = Mesh(tuple(cfg["mesh"]), tuple(cfg["mesh_axes"]), device=device)
    tcfg = TrainerConfig(adamw=AdamWConfig(lr=opt["lr"], b1=opt["b1"], b2=opt["b2"],
                                           eps=opt["eps"], weight_decay=opt["weight_decay"],
                                           grad_clip=opt["grad_clip"]),
                         warmup=opt["warmup"], total_steps=opt["total_steps"])
    seen = {"losses": [], "grad_norms": {}, "change_norms": {}}

    def global_norms(model, tensors: dict) -> dict:
        specs = laid_out_specs(model)
        return {k: M.unshard(t, mesh, specs[k]) for k, t in tensors.items()}

    class Observed(Trainer):
        steps = 0

        def _step_fn(self, model, opt_state, batch, err_state):
            with spans.span("step"):
                out = super()._step_fn(model, opt_state, batch, err_state)
            i, self.steps = self.steps, self.steps + 1
            if i < checked:
                seen["losses"].append(float(out[3]["loss"]))
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

    trainer = Observed(mcfg, tcfg, model=build_model(mcfg, weights), mesh=mesh,
                       policy=make_policy(mcfg, mesh, seq_parallel=tr["seq_parallel"]))
    try:
        trainer.fit(Feed(), steps=1 << 62, seed=seed)
    except WindowClosed:
        pass
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del trainer, weights
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    traced = T.reduce_profile(clock["prof"]) if clock["prof"] is not None else None
    clock.pop("prof")

    batches = [{k: torch.from_numpy(v).to(device)
                for k, v in inputs.token_batch(seed, s, B, S, V).items()} for s in range(checked)]
    ref = llama.train_readings(cfg, opt, inputs.llama_weights(cfg, seed, device, dtype), batches)
    gaps = llama.compare(seen, ref)
    window_s, steps = clock["close"] - clock["open"], clock["steps"]
    return Run(
        setup_s=clock["open"] - started, window_s=window_s, units=steps, attempted=steps,
        end_to_end={"train_tokens_per_s": steps * B * S / window_s if window_s > 0 else 0.0,
                    "setup_s": clock["open"] - started},
        checks={k: (gaps[k], tr["limits"][k]) for k in ("loss_gap", "grad_gap", "change_gap")},
        shapes={"config": cfg, "batch": B, "seq": S},
        device_kind=torch.cuda.get_device_name(0) if cuda else "cpu",
        memory_peak_bytes=int(peak), trace=traced)
