"""The controls on the card, at the cells' own sizes (about four minutes in
all): the reference in the program's place, one precision below the
configuration's, fails the cell's limits where the program meets them.
Run on a machine with a card:
``python -m pytest -m cuda portbench/test_portbench_controls.py``.
The readings that the limits were set from, at the cells' own sizes, come
from ``controls.py``."""

import time

import pytest

from portbench import cell as C
from portbench import controls


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the port's CUDA kernels have no CPU mode")
    return "cuda"


def limits_failed(readings: dict, cell) -> list:
    lim = cell.traffic["limits"]
    return [k for k, v in readings.items() if not v <= lim[k]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ("yi6b-summa-up", "yi6b-fcl-out", "yi6b-summa-up.ring"))
def test_gemm_control_fails_where_program_passes(cuda, name):
    cell = C.load_cell(name)
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        run = C.driver_of(cell).run(cell, seed, 0.2, False, cuda, time.perf_counter())
        assert run.correct, run.checks
        assert limits_failed(controls.control_gemm(cell, seed, cuda), cell)


@pytest.mark.cuda
def test_train_control_fails_where_program_passes(cuda):
    cell = C.load_cell("yi6b-8l-train")
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        run = C.driver_of(cell).run(cell, seed, 0.0, False, cuda, time.perf_counter())
        assert run.correct, run.checks
        assert limits_failed(controls.control_train(cell, seed, cuda), cell)
