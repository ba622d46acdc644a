"""Faults planted underneath a run's timed path, to show that the check that
decides ``correct`` catches them (``test_portbench_faults.py`` on the CPU,
``controls.py`` on the card).  Each is a context manager that patches the
program while it is open.

For the collective GEMM cells: ``unchanged`` (the products return their
accumulator as it was), ``half_batch`` (each product sums over the first
half of its inner dim and doubles it: the mean over the rest),
``no_exchange`` (``psum`` and ``ppermute`` return the member's own
block), ``altered`` (one element of each product's result off by one).
For the training cell: ``unchanged`` (AdamW's new parameters dropped: the
step leaves them as they were), ``half_batch`` (the labels of the second
half of the rows ignored: the loss is the mean over the rest),
``no_exchange`` (``sum_copies``, the data-parallel all-reduce of the
gradients, left out), ``altered`` (the loss as it is produced off by
``LOSS_OFFSET`` nats).
"""

from __future__ import annotations

import contextlib
from unittest import mock

KINDS = ("unchanged", "half_batch", "no_exchange", "altered")
LOSS_OFFSET = 0.05


def _gemm_fault(kind: str, gemm):
    def faulty(a, b, c=None, accumulate=False, **kw):
        if kind == "unchanged":
            return c if accumulate else a.new_zeros(a.shape[:-1] + b.shape[-1:])
        if kind == "half_batch":
            h = a.shape[-1] // 2
            out = 2 * gemm(a[..., :h].contiguous(), b[..., :h, :].contiguous())
            return c + out if accumulate else out
        out = gemm(a, b, c, accumulate=accumulate, **kw)
        out.view(-1, out.shape[-1])[0, 0] += 1.0
        return out
    return faulty


@contextlib.contextmanager
def collective_gemm(kind: str):
    """``kind`` planted in the collective GEMM entry points."""
    from repro_torch.core import fcl, summa
    from repro_torch.core import mesh as M

    with contextlib.ExitStack() as stack:
        if kind == "no_exchange":
            stack.enter_context(mock.patch.object(M, "psum", lambda x, axis: x))
            stack.enter_context(mock.patch.object(M, "ppermute", lambda x, axis, perm: x))
        else:
            for mod in (summa, fcl):
                stack.enter_context(mock.patch.object(mod, "gemm", _gemm_fault(kind, mod.gemm)))
        yield


@contextlib.contextmanager
def train(kind: str):
    """``kind`` planted in the trainer's step."""
    from repro_torch.core import mesh as M
    from repro_torch.models import transformer
    from repro_torch.runtime import trainer

    if kind == "unchanged":
        update = trainer.adamw_update

        def same(params, *args, **kw):
            _, state, metrics = update(params, *args, **kw)
            return {k: p.detach() for k, p in params.items()}, state, metrics
        patch = mock.patch.object(trainer, "adamw_update", same)
    elif kind == "no_exchange":
        patch = mock.patch.object(M, "sum_copies", lambda g, mesh, spec: g)
    else:
        loss_fn = transformer.loss_fn

        def faulty(model, batch, cfg, *args, **kw):
            if kind == "half_batch":
                labels = batch["labels"].clone()
                labels[labels.shape[0] // 2:] = -1
                batch = dict(batch, labels=labels)
                return loss_fn(model, batch, cfg, *args, **kw)
            return loss_fn(model, batch, cfg, *args, **kw) + LOSS_OFFSET
        patch = mock.patch.object(transformer, "loss_fn", faulty)
    with patch:
        yield


def planted(driver: str, kind: str):
    return {"collective_gemm": collective_gemm, "train": train}[driver](kind)
