"""The harness on the CPU: cells, traffic and metrics found by name, a cell
added as files only, BENCHMARK.json against the contract's shape, the
trace reduction, the metric readers and the result line."""

import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import cell as C
from portbench import trace as T

ROOT = Path(__file__).resolve().parent.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WORKLOADS = [w["name"] for w in SPEC["workloads"]]
METRICS = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]


@pytest.mark.parametrize("name", WORKLOADS)
def test_cell_found_by_name(name):
    cell = C.load_cell(name, ROOT)
    assert cell.traffic["driver"] in ("collective_gemm", "train")
    assert (cell.bench / "drivers" / f"{cell.traffic['driver']}.py").exists()
    assert "setup_s" in [m["name"] for m in cell.end_to_end]
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    reported = {m["name"] for m in cell.end_to_end}
    assert all(m["moves"] in reported for m in cell.per_layer)


@pytest.mark.parametrize("name", [m["name"] for m in SPEC["per_layer"]])
def test_metric_reader_found_by_name(name):
    assert callable(C.metric_reader(name))


def test_contract_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len(WORKLOADS) == len(set(WORKLOADS)) and len(METRICS) == len(set(METRICS))
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
        assert w["chips"] == 1
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).exists() and c["file"].startswith(SPEC["paths"][0] + "/")
        assert set(c["reduced"]) == set(json.loads((ROOT / c["file"]).read_text())["reduced"])
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", WORKLOADS)) <= set(WORKLOADS)
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert layers <= {"Entry points", "Layout and collectives", "Kernels", "Device"}


def test_cell_added_as_files_only(tmp_path):
    """A new cell needs a traffic file and entries in BENCHMARK.json, no code."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    traffic = json.loads((ROOT / "portbench/traffic/yi6b-summa-up.json").read_text())
    traffic.update(tokens=256)
    (tmp_path / "portbench/traffic/yi6b-summa-up.t256.json").write_text(json.dumps(traffic))
    (tmp_path / "portbench/metrics/share.new.py").write_text("def read(run):\n    return 1.5\n")
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "yi6b-summa-up.t256", "config": "yi-6b.layer",
                              "traffic": "yi6b-summa-up.t256", "chips": 1, "why": "t256"})
    spec["per_layer"].append({"name": "share.new", "unit": "%", "better": "higher",
                              "source": "device_trace", "layer": "Kernels",
                              "moves": "summa_call_ms", "workloads": ["yi6b-summa-up.t256"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = C.load_cell("yi6b-summa-up.t256", tmp_path)
    assert cell.traffic["tokens"] == 256 and cell.config["hidden_size"] == 4096
    assert cell.bench == tmp_path / "portbench"
    assert "share.new" in [m["name"] for m in cell.per_layer]
    assert C.metric_reader("share.new", cell.bench)(None) == 1.5
    assert C.driver_of(cell).make_call  # the general driver, unchanged


def test_trace_reduction():
    ms = 1e-3
    device = [("void gemm_kernel<float, 128, 128, true>(float const*)", 0 * ms, 4 * ms),
              ("void (anonymous namespace)::reduce_kernel<float, 0, 0, 4>(float*)", 3 * ms, 5 * ms),
              ("Memcpy DtoD (Device -> Device)", 7 * ms, 8 * ms),
              ("void gemm_kernel<float, 128, 128, true>(float const*)", 9 * ms, 10 * ms)]
    cpu = [("pb:call", 0 * ms, 6.5 * ms), ("pb:synchronize", 6.5 * ms, 10 * ms),
           ("pb:call", 8.5 * ms, 9.2 * ms)]
    t = T.reduce_events(device, cpu)
    assert t.busy_s == pytest.approx(7 * ms)
    assert t.window_s == pytest.approx(10 * ms)
    assert t.seconds_in(("gemm_kernel",)) == pytest.approx(5 * ms)
    assert t.launches_of(("gemm_kernel",)) == 2 and t.launches_of(("reduce_kernel",)) == 1
    assert [round(s / ms, 6) for _, s in t.gaps] == [2.0, 1.0]
    assert [n for n, _ in t.gaps] == ["call", "call"]  # 5-7 ms inside call; 8-9 the inner call
    b = t.breakdown()
    assert b["device_ops"][0][0] == "gemm_kernel<float, 128, 128, true>"
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_trace_tells_pytorch_reductions_from_reduce_nway():
    """PyTorch's own reduction kernel (the clip norm's sums, the norms'
    means, the loss head's max) shares the base name of reduce_nway's and
    is never counted as it."""
    ms = 1e-3
    device = [("void (anonymous namespace)::reduce_kernel<float, 0, 0, 4>(float*, long)",
               0 * ms, 1 * ms),
              ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
               "at::native::func_wrapper_t<float, at::native::sum_functor<float, float, float>"
               "::operator()(at::TensorIterator&)::{lambda(float, float)#1}>, unsigned int, "
               "float, 4, 4> >(at::native::ReduceOp<float>)", 1 * ms, 3 * ms),
              ("void at::native::(anonymous namespace)::reduce_kernel<128, 4>(float*)",
               3 * ms, 7 * ms)]
    t = T.reduce_events(device, [])
    assert t.seconds_in(("reduce_kernel",)) == pytest.approx(1 * ms)
    assert t.launches_of(("reduce_kernel",)) == 1
    assert T.kernel_name(device[1][0]).startswith("at::native::reduce_kernel<512")
    run = fake_run(m=4096, k=4096, n=4096, members=8, dtype="float32", itemsize=4)
    run.trace = t
    assert C.metric_reader("reduce_nway_ms.train")(run) == pytest.approx(1 * ms / 100 * 1e3)
    bytes_ = 9 * 4096 * 4096 * 4
    assert C.metric_reader("reduce_nway_roofline.fcl")(run) == pytest.approx(
        100 * bytes_ / 3.35e12 * 100 / (1 * ms), rel=1e-6)
    del t.kernels["reduce_kernel<float, 0, 0, 4>"]
    assert C.metric_reader("reduce_nway_ms.train")(run) is None
    assert C.metric_reader("reduce_nway_roofline.fcl")(run) is None


def test_trace_keeps_the_checks_apart():
    """Operations that a ``check`` span launched are the benchmark's: busy,
    but neither a product nor a collective of the program."""
    ms = 1e-3
    device = [("void gemm_kernel<float, 128, 128, true>(float const*)", 0 * ms, 4 * ms),
              ("void at::native::reduce_kernel<512, 1>(float*)", 4 * ms, 5 * ms),
              ("Memcpy DtoD (Device -> Device)", 5 * ms, 6 * ms)]
    cpu = [("pb:call", 0 * ms, 1 * ms), ("pb:check", 1 * ms, 1.5 * ms)]
    assert T.launched_in([(1 * ms, 1.5 * ms), (3 * ms, 4 * ms)],
                         [(7, 0.5 * ms), (8, 1.2 * ms), (0, 1.3 * ms), (9, 3.5 * ms),
                          (10, 4.5 * ms)]) == {8, 9}
    t = T.reduce_events(device, cpu, checked=[1])
    assert t.busy_s == pytest.approx(6 * ms)
    assert list(t.checks) == ["at::native::reduce_kernel<512, 1>"]
    assert "at::native::reduce_kernel<512, 1>" not in t.kernels
    run = fake_run(m=4096, k=4096, n=11008, members=16, dtype="float32", itemsize=4)
    run.trace = t
    assert C.metric_reader("collective_ms.summa")(run) == pytest.approx(1 * ms / 100 * 1e3)
    assert ["pb:check at::native::reduce_kernel<512, 1>", 1 * ms] in t.breakdown()["device_ops"]


def fake_run(trace=True, **shapes):
    kernels = {"gemm_kernel<float, 128, 128, true>": (2.0, 400),
               "reduce_kernel<float, 0, 0, 4>": (0.25, 100),
               "elementwise_kernel<direct_copy>": (0.5, 800),
               "flash_wgmma_kernel<128>": (0.4, 16)}
    t = T.Trace(kernels, busy_s=2.75, window_s=3.0, gaps=[("call", 0.01)]) if trace else None
    return C.Run(setup_s=5.0, window_s=3.0, units=100, attempted=100,
                 end_to_end={"summa_call_ms": 30.0, "summa_call_p95_ms": 31.0, "setup_s": 5.0},
                 checks={"max_rel_err": (1e-6, 3e-5), "sum_rel_err": (2e-7, 1e-5)},
                 shapes=shapes, device_kind="fake",
                 memory_peak_bytes=1, trace=t)


@pytest.mark.parametrize("entry", ("summa", "ring", "fcl"))
def test_gemm_metric_readers(entry):
    run = fake_run(m=4096, k=4096, n=11008, members=16, dtype="float32", itemsize=4)
    names = [f"mfu.{entry}", f"gemm_roofline.{entry}", f"collective_ms.{entry}",
             f"device_idle.{entry}", "reduce_nway_roofline.fcl"]
    read = {n: C.metric_reader(n) for n in names}
    assert read[f"mfu.{entry}"](run) == pytest.approx(
        100 * 369.4e9 * 100 / 3.0 / 164.9e12, rel=1e-3)
    assert read[f"gemm_roofline.{entry}"](run) == pytest.approx(
        100 * 369.4e9 / 164.9e12 * 100 / 2.0, rel=1e-3)
    assert read[f"collective_ms.{entry}"](run) == pytest.approx((0.25 + 0.5 + 0.4) / 100 * 1e3)
    assert read[f"device_idle.{entry}"](run) == pytest.approx(100 * (1 - 2.75 / 3.0))
    bytes_ = 17 * 4096 * 11008 * 4
    assert read["reduce_nway_roofline.fcl"](run) == pytest.approx(
        100 * bytes_ / 3.35e12 * 100 / 0.25, rel=1e-6)
    untraced = fake_run(trace=False, m=1, k=1, n=1, members=1, dtype="float32", itemsize=4)
    assert all(r(untraced) is None for r in read.values())


def test_train_metric_readers():
    cfg = json.loads((ROOT / "portbench/configs/yi-6b.8l-tp2x4.json").read_text())
    run = fake_run(config=cfg, batch=2, seq=4096)
    mfu = C.metric_reader("mfu.train")(run)
    assert mfu == pytest.approx(100 * 87.51e12 * 100 / 3.0 / 989e12, rel=1e-3)
    assert C.metric_reader("reduce_nway_ms.train")(run) == pytest.approx(2.5)
    flash = C.metric_reader("flash_roofline.train")(run)
    assert flash == pytest.approx(100 * 2 * 2.19936e12 * 100 / 989e12 / 0.4, rel=1e-3)
    run.trace.kernels.pop("reduce_kernel<float, 0, 0, 4>")
    assert C.metric_reader("reduce_nway_ms.train")(run) is None


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    cell = C.load_cell("yi6b-summa-up", ROOT)
    run = fake_run(m=4096, k=4096, n=11008, members=16, dtype="float32", itemsize=4)
    line = C.result_line(cell, run, trace)
    assert list(line) == (["correct", "attempted", "failed", "metrics", "device"]
                          + ["breakdown"] * trace + ["checks"])
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] == 100
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"} | (
        {"busy_s", "window_s"} if trace else set())
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(line["metrics"]) == want
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert line["checks"] == {"max_rel_err": {"value": 1e-6, "limit": 3e-5},
                              "sum_rel_err": {"value": 2e-7, "limit": 1e-5}}
    json.dumps(line)
    run.checks["max_rel_err"] = (float("nan"), 3e-5)
    assert C.result_line(cell, run, trace)["correct"] is False
