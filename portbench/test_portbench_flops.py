"""The yardstick's arithmetic against the numbers it was set from: SUMMA
369.4 GFLOP, FCL 137.4 GFLOP, a Yi-6B 8-layer training step 87.5 model
TFLOP (80.9 of products, 6.6 of attention), and the kernels' bounds."""

import json
from pathlib import Path

import pytest

from portbench import flops

ROOT = Path(__file__).resolve().parent.parent


def config(name):
    return json.loads((ROOT / "portbench/configs" / f"{name}.json").read_text())


def test_collective_gemm_flops():
    layer = config("yi-6b.layer")
    d, f = layer["hidden_size"], layer["intermediate_size"]
    assert flops.gemm_flops(4096, d, f) / 1e9 == pytest.approx(369.4, abs=0.05)
    assert flops.gemm_flops(4096, layer["num_attention_heads"] * layer["head_dim"], d) / 1e9 \
        == pytest.approx(137.4, abs=0.05)


def test_train_flops():
    cfg = config("yi-6b.8l-tp2x4")
    assert flops.dense_weights(cfg) == 8 * 173_015_040 + 64000 * 4096
    products = 3 * 2 * 2 * 4096 * flops.dense_weights(cfg)
    attention = 3 * flops.attention_flops(cfg, 2, 4096)
    assert products / 1e12 == pytest.approx(80.9, abs=0.05)
    assert attention / 1e12 == pytest.approx(6.6, abs=0.05)
    assert flops.train_flops(cfg, 2, 4096) / 1e12 == pytest.approx(87.5, abs=0.05)


def test_bounds():
    # the SUMMA step of the kernel table: 16 x (1024 x 1024 @ 1024 x 2752) f32 + C
    step = flops.gemm_flops(16 * 1024, 1024, 2752)
    assert flops.product_bound_s(step, 0, "float32") * 1e3 == pytest.approx(0.560, abs=0.001)
    assert flops.PEAK_F32_ACCURATE == pytest.approx(164.9e12, rel=1e-3)
    # reduce_nway (8, 4096^2) f32: 8 read, 1 written
    assert flops.reduce_bytes(8, 4096 ** 2, 4) / flops.PEAK_BYTES * 1e3 == pytest.approx(
        0.1803, abs=1e-4)
    assert flops.bound_s(1.0, 1.0, 1e15)[1] == "bytes"
    assert flops.product_bound_s(989e12, 0, "bfloat16") == pytest.approx(1.0)
    assert flops.causal_pairs(4096) == 4096 * 4097 // 2
    assert flops.causal_pairs(10, 4) == 4 * 5 // 2 + 6 * 4
