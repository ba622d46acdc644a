"""Perf hill-climb driver: re-trace chosen cells with candidate changes.

The port's counterpart of ``src/repro/launch/hillclimb.py``, with the
reference's variants, names and transforms.  Each variant's record goes to
``results/dryrun_torch.json`` under the variant's name, beside the
baseline of ``launch/dryrun.py``.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell phi3_5_moe:train_4k \\
      --variant bf16_attn

The ``attn_q_chunk`` variants change nothing in the port: the flash
kernel already works in blocks, and the port ignores the field
(``models/common.py``); their records say so (``"no_effect"``) and equal
the baseline's.  ``scan_layers`` changes nothing in the port either, so
there is no ``--scan-memory`` pass: the one trace gives the memory.
"""

from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs import get_config
from repro_torch.launch.dryrun import append_result, run_cell

# variant name -> (cfg transform, build_opts)
VARIANTS = {
    # memory-term levers
    "attn_chunk_512": (lambda c: dataclasses.replace(c, attn_q_chunk=512), {}),
    "attn_chunk_1024": (lambda c: dataclasses.replace(c, attn_q_chunk=1024), {}),
    "loss_chunk_256": (lambda c: dataclasses.replace(c, loss_chunk=256), {}),
    "loss_chunk_512": (lambda c: dataclasses.replace(c, loss_chunk=512), {}),
    "attn512_loss256": (lambda c: dataclasses.replace(
        c, attn_q_chunk=512, loss_chunk=256), {}),
    "cap_factor_1": (lambda c: dataclasses.replace(c, capacity_factor=1.0), {}),
    "bf16_attn": (lambda c: dataclasses.replace(c, attn_bf16_logits=True), {}),
    "no_remat": (lambda c: dataclasses.replace(c, remat=False), {}),
    "moe_token_shard": (lambda c: dataclasses.replace(c, moe_token_shard=True), {}),
    "moe_shard_cap1": (lambda c: dataclasses.replace(
        c, moe_token_shard=True, capacity_factor=1.0), {}),
    "bf16_attn_loss256": (lambda c: dataclasses.replace(
        c, attn_bf16_logits=True, loss_chunk=256), {}),
    "bf16_attn_noremat": (lambda c: dataclasses.replace(
        c, attn_bf16_logits=True, remat=False), {}),
    "attn512_noremat": (lambda c: dataclasses.replace(
        c, attn_q_chunk=512, remat=False), {}),
    # collective-term levers
    "align_decode": (lambda c: c, {"align_decode_cache": True}),
    "sp_prefill": (lambda c: c, {"seq_parallel": True}),
    "no_sp": (lambda c: c, {"seq_parallel": False}),
    "no_zero1": (lambda c: c, {"zero1": False}),
    # combos
    "align_decode_attn512": (lambda c: dataclasses.replace(c, attn_q_chunk=512),
                             {"align_decode_cache": True}),
    "align_bf16": (lambda c: dataclasses.replace(c, attn_bf16_logits=True),
                   {"align_decode_cache": True}),
    "moe_shard_sp": (lambda c: dataclasses.replace(c, moe_token_shard=True),
                     {"seq_parallel": True}),
    "bf16_attn_sp_moe": (lambda c: dataclasses.replace(
        c, attn_bf16_logits=True, moe_token_shard=True), {"seq_parallel": True}),
    "sp_prefill_attn512": (lambda c: dataclasses.replace(c, attn_q_chunk=512),
                           {"seq_parallel": True}),
}

# Config fields the port reads nowhere (``models/common.py``): a variant
# that changes only these traces the baseline again.
NO_EFFECT_FIELDS = ("attn_q_chunk",)


def no_effect(arch: str, variant: str) -> bool:
    """Whether ``variant`` changes only fields the port ignores."""
    transform, build_opts = VARIANTS[variant]
    base = get_config(arch)
    changed = {f.name for f in dataclasses.fields(base)
               if getattr(transform(base), f.name) != getattr(base, f.name)}
    return bool(changed) and changed <= set(NO_EFFECT_FIELDS) and not build_opts


def run_variant(arch: str, shape: str, variant: str, **kw) -> dict:
    """``run_cell`` of ``arch:shape`` under ``variant``, its record marked
    ``no_effect`` where the variant changes nothing in the port."""
    transform, build_opts = VARIANTS[variant]
    cfg = transform(kw.pop("cfg", None) or get_config(arch))
    rec = run_cell(arch, shape, cfg_override=cfg, build_opts=build_opts, variant=variant, **kw)
    rec["no_effect"] = no_effect(arch, variant)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, help="arch:shape")
    ap.add_argument("--variant", required=True, choices=list(VARIANTS))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    arch, shape = args.cell.split(":")
    append_result(run_variant(arch, shape, args.variant, device=args.device))


if __name__ == "__main__":
    main()
