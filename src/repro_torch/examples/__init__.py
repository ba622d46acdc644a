"""The reference's six examples (``examples/*.py``), run on the port.

One module per script, with the reference's names, each run as
``python -m repro_torch.examples.<name>``:

* ``collective_schedules``, ``telemetry`` and ``service`` drive the
  fabric on the host and print the reference's lines;
* ``distributed_gemm``, ``quickstart`` and ``fault_tolerance`` run on the
  card (``--device cuda``, the default; without a card they stop before
  printing anything) or, when asked, on the host (``--device cpu``, the
  kernels' plain versions).  Their fabric halves print the reference's
  lines as well.

Importing a module runs nothing: each ``main`` runs under ``__main__``.
This package imports no torch, so that the host-only ones load none.
"""

from __future__ import annotations

import argparse


def parse_device(doc: str, argv=None):
    """The ``--device {cuda,cpu}`` of a card-touching example (``cuda`` by
    default): a parser error, exit code 2, when it asks for a card that is
    not there."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the hand-written kernels (default); cpu: their plain "
                         "versions on the host")
    args = ap.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device; pass --device cpu to run the plain versions on the host")
    return torch.device(args.device)


def where(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else "the host CPU"
