"""The Moonlight cell's pieces on the CPU: its driver at a small size in f32
(a sound run comes out correct, each training fault of ``faults.py`` and
each fault of the selection bias in ``controls_moonlight.py`` planted
under the timed path comes out not correct), its weights named as the
program's parameters, its FLOP counts and its metric readers."""

import json
import time
from pathlib import Path

import pytest

from portbench import cell as C
from portbench import controls_moonlight, faults, flops_moonlight
from portbench import trace as T
from portbench.program_spans import Program

ROOT = Path(__file__).resolve().parent.parent
NAME = "moonlight-6l-ep4-train"
CONFIG = json.loads((ROOT / "portbench/configs/moonlight-16b-a3b.6l-ep4.json").read_text())


def small(**config):
    cell = C.load_cell(NAME, ROOT)
    cell.config = dict(cell.config, hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
                       qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, kv_lora_rank=32,
                       intermediate_size=128, moe_intermediate_size=32, n_routed_experts=8,
                       num_experts_per_tok=3, num_hidden_layers=3, vocab_size=512,
                       torch_dtype="float32", **config)
    cell.traffic = dict(cell.traffic, seq=32)
    return cell


def run(cell, seed, fault=None):
    t = time.perf_counter()
    drive = C.driver_of(cell).run
    if fault is None:
        return drive(cell, seed, 0.05, False, "cpu", t)
    with controls_moonlight.planted(fault):
        return drive(cell, seed, 0.05, False, "cpu", t)


@pytest.mark.parametrize("fault", (None,) + faults.KINDS)
def test_moonlight_cell_faults(fault):
    r = run(small(), 2 ** 31 + 107, fault)
    assert set(r.checks) == {"loss_gap", "grad_gap", "change_gap", "route_gap", "bias_gap"}
    assert r.correct is (fault is None), r.checks
    assert r.units >= 1 and r.end_to_end["train_tokens_per_s"] > 0


@pytest.mark.parametrize("fault", (None,) + controls_moonlight.BIAS_FAULTS)
def test_moonlight_cell_bias_faults(fault):
    """Each fault of the selection bias fails the cell's limits.  The bias
    moves at 0.05 a step here, so that at the small size it moves the
    choice of many tokens, as 0.001 does among the 64 close scores of the
    published router."""
    r = run(small(bias_update_speed=0.05), 2 ** 31 + 109, fault)
    assert r.correct is (fault is None), r.checks
    assert r.routing[0]["differing"] == 0  # f32 both, and no bias yet in the first step


def test_weights_are_the_programs_parameters():
    import torch

    from repro_torch.models import transformer as tt

    cell = small()
    drv = C.driver_of(cell)
    mcfg = drv.model_config(cell.config)
    w = drv.moonlight_weights(cell.config, 5, "cpu", torch.float32)
    model = tt.from_named(mcfg, w)
    assert {k: tuple(p.shape) for k, p in model.named_parameters()} == \
        {k: tuple(t.shape) for k, t in w.items()}
    assert w["blocks.1.moe.router"].dtype == torch.float32
    again = drv.moonlight_weights(cell.config, 5, "cpu", torch.float32)
    assert all(torch.equal(w[k], again[k]) for k in w)


def test_flops_at_the_published_widths():
    # 834.0 M product weights a token: 6 x 13.76 M of MLA, the dense layer's
    # 69.2 M, 5 MoE layers of 69.3 M active (router, 6 routed, 2 shared),
    # the head's 335.5 M; attention 2 x 320 per pair per head
    assert flops_moonlight.active_weights(CONFIG) == 834_011_136
    per_token = (2 * flops_moonlight.active_weights(CONFIG)
                 + flops_moonlight.attention_flops(CONFIG, 1, 8192) / 8192)
    assert per_token == pytest.approx(1.92e9, rel=2e-3)
    assert flops_moonlight.attention_flops(CONFIG, 4, 8192) == \
        2 * 320 * 16 * 4 * (8192 * 8193 // 2) * 6
    assert flops_moonlight.train_flops(CONFIG, 4, 8192) == pytest.approx(
        3 * 4 * 8192 * per_token, rel=1e-12)


def fake_run(trace=True, counters=None):
    kernels = {"flash_wgmma_kernel<192, 128>": (0.5, 120), "gemm_kernel": (1.0, 10)}
    tr = T.Trace(kernels=kernels, busy_s=9.0, window_s=10.0, gaps=[]) if trace else None
    if tr is not None:
        s = 1e-9
        tr.program = Program(
            spans=[("moe", 0.0, 1.0, 1), ("moe.backward", 2.0, 3.0, 2),
                   ("collective.all_to_all", 0.1, 0.2, 1), ("mla", 1.0, 2.0, 1)],
            ops=[(0.10, 0.10 + 3 * s * 1e6, 0.15, 1), (0.5, 0.5 + 2e-3, 0.6, 1),
                 (2.5, 2.5 + 4e-3, 2.5, 2), (1.5, 1.6, 1.5, 1)])
    r = C.Run(setup_s=1.0, window_s=10.0, units=5, attempted=5, end_to_end={}, checks={},
              shapes={"config": CONFIG, "batch": 4, "seq": 8192}, device_kind="H100",
              memory_peak_bytes=0, trace=tr)
    r.counters = counters
    return r


def test_metric_readers():
    read = {n: C.metric_reader(n) for n in ("mfu.moonlight", "moe_ms.moonlight",
                                            "all_to_all_ms.moonlight",
                                            "mla_flash_roofline.moonlight",
                                            "dropped_pairs.moonlight", "device_idle.moonlight")}
    r = fake_run(counters={"moe.routed_pairs": 400, "moe.dropped_pairs": 30})
    step = flops_moonlight.train_flops(CONFIG, 4, 8192)
    assert read["mfu.moonlight"](r) == pytest.approx(100 * step * 5 / 10.0 / 989e12)
    assert read["moe_ms.moonlight"](r) == pytest.approx((3e-3 + 2e-3 + 4e-3) / 5 * 1e3)
    assert read["all_to_all_ms.moonlight"](r) == pytest.approx(3e-3 / 5 * 1e3)
    att = flops_moonlight.attention_flops(CONFIG, 4, 8192)
    assert read["mla_flash_roofline.moonlight"](r) == pytest.approx(
        100 * 2 * att * 5 / 989e12 / 0.5)
    assert read["dropped_pairs.moonlight"](r) == pytest.approx(7.5)
    assert read["device_idle.moonlight"](r) == pytest.approx(10.0)
    # what a program without the spans and counters gives: nothing, no error
    bare = fake_run()
    bare.trace.program = Program()
    assert read["moe_ms.moonlight"](bare) is None
    assert read["all_to_all_ms.moonlight"](bare) is None
    assert read["dropped_pairs.moonlight"](bare) is None
    untraced = fake_run(trace=False)
    assert all(r(untraced) is None for r in read.values())
