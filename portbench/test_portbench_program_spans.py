"""The readings of the program's spans (``program_spans.py``) on fixed event
lists, as ``test_trace_reduction`` holds the trace's: an operation counts
where its launch lies in a span on the launching thread, nested spans once,
a backward's launches from autograd's own thread in its span; every reading
is None without the program's spans.  ``collect`` on a CPU profile, and on
the card one traced SUMMA call, whose collectives and launches read above
zero (``python -m pytest -m cuda portbench/test_portbench_program_spans.py``)."""

import types

import pytest

from portbench import program_spans as P

MS = 1e-3
MAIN, AUTOGRAD = 101, 202


def _program():
    """Two calls on the main thread, each a ``summa`` span holding nested
    collectives; then a region's forward on the main thread and its backward
    on autograd's thread, overlapping in time with a main-thread span."""
    spans = [("summa", 0 * MS, 10 * MS, MAIN),
             ("collective.broadcast", 1 * MS, 4 * MS, MAIN),
             ("collective.psum", 2 * MS, 3 * MS, MAIN),
             ("summa", 20 * MS, 30 * MS, MAIN),
             ("collective.broadcast", 21 * MS, 22 * MS, MAIN),
             ("blocks", 40 * MS, 50 * MS, MAIN),
             ("blocks.backward", 55 * MS, 70 * MS, AUTOGRAD),
             ("optimizer", 60 * MS, 65 * MS, MAIN)]
    # (start, end, launched at, thread): device times lag the launches
    ops = [(5 * MS, 6 * MS, 0.5 * MS, MAIN),       # summa: a shard copy
           (6 * MS, 8 * MS, 2.5 * MS, MAIN),       # summa > broadcast > psum
           (8 * MS, 9 * MS, 3.5 * MS, MAIN),       # summa > broadcast
           (9 * MS, 14 * MS, 9.0 * MS, MAIN),      # summa: the product
           (14 * MS, 15 * MS, 12.0 * MS, MAIN),    # outside: the benchmark's check
           (25 * MS, 27 * MS, 21.5 * MS, MAIN),    # summa > broadcast
           (45 * MS, 48 * MS, 41.0 * MS, MAIN),    # blocks
           (58 * MS, 62 * MS, 56.0 * MS, AUTOGRAD),  # blocks.backward
           (62 * MS, 63 * MS, 61.0 * MS, AUTOGRAD),  # blocks.backward, in optimizer's time
           (66 * MS, 67 * MS, 62.0 * MS, MAIN),    # optimizer
           (70 * MS, 71 * MS, None, None)]         # no launch found
    return P.Program(spans, ops)


def test_attribution_by_launch_with_nested_spans_counted_once():
    prog = _program()
    assert P.device_s(prog, ("summa",)) == pytest.approx(11 * MS)
    assert P.launches(prog, ("summa",)) == 5
    # psum inside broadcast: once
    assert P.device_s(prog, ("collective.*",)) == pytest.approx(5 * MS)
    assert P.launches(prog, ("collective.*",)) == 3
    assert P.device_s(prog, ("collective.psum",)) == pytest.approx(2 * MS)
    assert P.host_s(prog, ("summa",)) == pytest.approx(20 * MS)
    assert P.host_s(prog, ("collective.*",)) == pytest.approx(4 * MS)  # nested: once


def test_launches_from_a_second_thread():
    """The backward's launches, on autograd's thread, are its span's even
    while the main thread is inside another span."""
    prog = _program()
    assert P.device_s(prog, ("blocks", "blocks.backward")) == pytest.approx(8 * MS)
    assert P.launches(prog, ("blocks.backward",)) == 2
    assert P.device_s(prog, ("optimizer",)) == pytest.approx(1 * MS)
    assert P.host_s(prog, ("blocks", "blocks.backward")) == pytest.approx(25 * MS)


def test_none_without_program_spans():
    prog = _program()
    assert P.device_s(prog, ("fcl",)) is None
    assert P.launches(prog, ("loss_head",)) is None
    assert P.host_s(prog, ("fcl",)) is None
    empty = P.Program()
    assert P.device_s(empty, ("collective.*",)) is None and P.idle_by_span(empty) == {}
    run = types.SimpleNamespace(trace=types.SimpleNamespace(kernels={}), units=10)
    assert P.comm_ms(run) is None and P.host_call_ms(run, "summa") is None
    run.trace = None
    assert P.launches_per_call(run, "summa") is None and P.region_ms(run, "blocks") is None


def test_per_unit_readings():
    run = types.SimpleNamespace(trace=types.SimpleNamespace(program=_program()), units=2)
    assert P.host_call_ms(run, "summa") == pytest.approx(10.0)
    assert P.launches_per_call(run, "summa") == pytest.approx(2.5)
    assert P.comm_ms(run) == pytest.approx(2.5)
    assert P.region_ms(run, "blocks") == pytest.approx(4.0)
    assert P.region_ms(run, "optimizer") == pytest.approx(0.5)


def test_idle_by_span():
    """Idle stretches between the first and last operation go to the
    innermost span open at each moment, on any thread."""
    prog = P.Program([("summa", 0 * MS, 10 * MS, MAIN),
                      ("collective.psum", 2 * MS, 4 * MS, MAIN),
                      ("blocks.backward", 3 * MS, 6 * MS, AUTOGRAD)],
                     [(0 * MS, 1 * MS, 0, MAIN), (5 * MS, 7 * MS, 0, MAIN),
                      (12 * MS, 13 * MS, 0, MAIN)])
    idle = P.idle_by_span(prog)
    # idle: 1-5 ms and 7-12 ms; 1-2 summa, 2-3 psum, 3-5 blocks.backward (opened last),
    # 7-10 summa, 10-12 outside
    assert idle == pytest.approx({"summa": 4 * MS, "collective.psum": 1 * MS,
                                  "blocks.backward": 2 * MS, P.OUTSIDE: 2 * MS})


def test_collect_on_a_cpu_profile():
    import threading

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tracing

    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        with tracing.span("outer"):
            with tracing.span("inner"):
                torch.ones(4).sum()
    finally:
        prof.stop()
    prog = P.collect(prof)
    assert [s[0] for s in sorted(prog.spans, key=lambda s: s[1])] == ["outer", "inner"]
    assert {s[3] for s in prog.spans} == {threading.get_native_id()}
    assert prog.ops == []  # no device here
    assert P.host_s(prog, ("outer",)) >= P.host_s(prog, ("inner",)) > 0


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the port's CUDA kernels have no CPU mode")
    return "cuda"


@pytest.mark.cuda
def test_traced_summa_call_reads_collectives_and_launches(cuda):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.mesh import Mesh
    from repro_torch.core.summa import summa_sharded

    gen = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn(1024, 1024, generator=gen, device=cuda)
    b = torch.randn(1024, 2048, generator=gen, device=cuda)
    mesh = Mesh((4, 4), ("row", "col"), device=cuda)
    summa_sharded(a, b, mesh, "row", "col")  # the kernels' build and first launch
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    summa_sharded(a, b, mesh, "row", "col")
    torch.cuda.synchronize()
    prof.stop()
    prog = P.collect(prof)
    run = types.SimpleNamespace(trace=types.SimpleNamespace(program=prog), units=1)
    assert P.comm_ms(run) > 0 and P.launches_per_call(run, "summa") > 0
    assert P.host_call_ms(run, "summa") > 0
    assert P.launches(prog, ("collective.*",)) < P.launches(prog, ("summa",))
    unlaunched = [op for op in prog.ops if op[2] is None]
    assert not unlaunched, f"{len(unlaunched)} of {len(prog.ops)} operations without a launch"
