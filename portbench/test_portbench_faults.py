"""The rest of a run, without the look for a card, on the CPU at a small size:
a sound run comes out correct, and each fault of ``faults.py`` planted
under the timed path comes out not correct.  The training cell runs its
small size in f32, where the program and the reference agree to rounding,
so that the sound run is held to the cell's own limits."""

import time
from unittest import mock

import pytest

from portbench import cell as C
from portbench import faults

GEMM_CELLS = ("yi6b-summa-up", "yi6b-fcl-out", "yi6b-summa-up.ring")


def small_gemm(name):
    cell = C.load_cell(name)
    cell.config = dict(cell.config, hidden_size=64, intermediate_size=96, num_attention_heads=8,
                       head_dim=8, num_key_value_heads=2, num_hidden_layers=4, vocab_size=512)
    cell.traffic = dict(cell.traffic, tokens=32, warm_calls=1)
    return cell


def small_train():
    cell = C.load_cell("yi6b-8l-train")
    cell.config = dict(cell.config, hidden_size=64, intermediate_size=128, num_attention_heads=4,
                       num_key_value_heads=4, num_hidden_layers=2, vocab_size=512,
                       torch_dtype="float32")
    cell.traffic = dict(cell.traffic, seq=32)
    return cell


def run(cell, seed, fault=None, seconds=0.05):
    t = time.perf_counter()
    drive = C.driver_of(cell).run
    if fault is None:
        return drive(cell, seed, seconds, False, "cpu", t)
    with faults.planted(cell.traffic["driver"], fault):
        return drive(cell, seed, seconds, False, "cpu", t)


@pytest.mark.parametrize("name", GEMM_CELLS)
@pytest.mark.parametrize("fault", (None,) + faults.KINDS)
def test_gemm_cell_faults(name, fault):
    cell = small_gemm(name)
    r = run(cell, 2 ** 31 + 101, fault)
    assert r.correct is (fault is None), r.checks
    assert r.units >= 1 and r.end_to_end[f"{cell.traffic['series']}_call_ms"] > 0


@pytest.mark.parametrize("name", GEMM_CELLS)
def test_gemm_cell_checks_every_call(name):
    """A call that hands back the previous call's output, as a buffer reused
    across calls would, is caught by the column sums of every call, however
    few whole outputs are sampled: here the window's second call gives the
    first's."""
    from repro_torch.core import fcl, summa

    mod, entry = (summa, "summa_sharded") if "summa" in name else (fcl, "fcl_sharded")
    real, seen = getattr(mod, entry), []
    cell = small_gemm(name)
    cell.traffic = dict(cell.traffic, samples=1)
    warm = max(cell.traffic["warm_calls"], cell.traffic["samples"] + 2)

    def reused(*args, **kw):
        out = real(*args, **kw)
        seen.append(out)
        return seen[-2] if len(seen) == warm + 2 else out

    with mock.patch.object(mod, entry, reused):
        r = run(cell, 2 ** 31 + 102, seconds=0.5)
    assert r.units >= 2
    value, limit = r.checks["sum_rel_err"]
    assert not value <= limit and r.correct is False


@pytest.mark.parametrize("fault", (None,) + faults.KINDS)
def test_train_cell_faults(fault):
    r = run(small_train(), 2 ** 31 + 103, fault)
    assert r.correct is (fault is None), r.checks
    assert r.units >= 1 and r.end_to_end["train_tokens_per_s"] > 0
