"""Canonical sha256 fingerprints for simulation identities.

One module owns every content-addressed key in the NoC stack.  Three
ad-hoc builders grew independently and are consolidated here with their
**exact historical bytes** preserved (round-trip tested against frozen
copies of the legacy implementations):

* the sweep-journal key (``traffic/sweep.py`` ``_journal_key``) — sha256
  over a ``sort_keys`` JSON document with default separators and
  ``default=str``;
* the checkpoint fingerprint (``resilience/checkpoint.py``) — sha256
  over the compact (``separators=(",", ":")``) ``sort_keys`` dump;
* the compiled-workload identity the program tests pinned by hand —
  now :func:`program_fingerprint` / :func:`workload_fingerprint`,
  the keys of the service layer's compile cache and result memo
  (``service/cache.py``).

The distinction between the two serializations matters: a fingerprint is
only stable if its byte stream is, so each named key documents (and
tests pin) which canonical form it hashes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json


def canonical_json(doc, *, compact: bool = True, default=None) -> bytes:
    """Canonical (sorted-key) JSON bytes of ``doc``.

    ``compact=True`` uses ``separators=(",", ":")`` — the checkpoint
    form; ``compact=False`` keeps ``json.dumps`` default separators —
    the historical journal form.  Both sort keys, so dict insertion
    order never leaks into a fingerprint.
    """
    if compact:
        return json.dumps(doc, sort_keys=True, separators=(",", ":"),
                          default=default).encode()
    return json.dumps(doc, sort_keys=True, default=default).encode()


def digest(doc, *, compact: bool = True, default=None) -> str:
    """sha256 hex digest of the canonical JSON of ``doc``."""
    return hashlib.sha256(
        canonical_json(doc, compact=compact, default=default)).hexdigest()


# ---------------------------------------------------------------------------
# Shared document builders: the normalized sub-documents every key uses.
# ---------------------------------------------------------------------------


def mesh_doc(mesh) -> list:
    """``[cols, rows]`` — the canonical mesh identity."""
    return [mesh.cols, mesh.rows]


def params_doc(params) -> dict:
    """JSON-ready :class:`~repro_torch.core.noc.params.NoCParams` document.

    ``None`` normalizes to the default parameter set (so "defaulted" and
    "explicitly default" hash identically), and the ``faults`` hook is
    replaced by its own canonical ``to_dict`` serialization (or None).
    """
    from repro_torch.core.noc.params import NoCParams

    p = params or NoCParams()
    d = dataclasses.asdict(p)
    d.pop("faults", None)
    d["faults"] = p.faults.to_dict() if getattr(p, "faults", None) else None
    return d


def params_from_doc(d: dict):
    """Rebuild :class:`NoCParams` from :func:`params_doc` output (the
    service wire format)."""
    from repro_torch.core.noc.faults.model import FaultSet
    from repro_torch.core.noc.params import NoCParams

    kw = dict(d)
    if kw.get("faults") is not None:
        kw["faults"] = FaultSet.from_dict(kw["faults"])
    if kw.get("vc_map") is not None:
        kw["vc_map"] = tuple((cls, vc) for cls, vc in kw["vc_map"])
    return NoCParams(**kw)


# ---------------------------------------------------------------------------
# Sweep-journal key (bit-compatible with the historical _journal_key).
# ---------------------------------------------------------------------------


def sweep_doc(mesh, cfgs, params, engine, compile_once) -> dict:
    """The document the sweep-journal key hashes (component layout is
    public so mismatch diagnostics can name the differing component)."""
    return {
        "mesh": mesh_doc(mesh),
        "cfgs": [dataclasses.asdict(c) for c in cfgs],
        "params": params_doc(params),
        "engine": engine,
        "compile_once": bool(compile_once),
    }


def sweep_key(mesh, cfgs, params, engine, compile_once) -> str:
    """Identity of one sweep invocation: sha256 over everything that
    changes its results.  Byte-identical to the historical
    ``traffic.sweep._journal_key`` (non-compact separators,
    ``default=str``) — committed journals stay resumable."""
    return digest(sweep_doc(mesh, cfgs, params, engine, compile_once),
                  compact=False, default=str)


def sweep_key_parts(mesh, cfgs, params, engine, compile_once) -> dict:
    """Per-component digests of the sweep key, written into the journal
    header so a key mismatch can say *which* component differs (mesh /
    configs / params / engine / compile_once) instead of refusing with a
    bare hash."""
    doc = sweep_doc(mesh, cfgs, params, engine, compile_once)
    return {k: digest(v, compact=False, default=str)
            for k, v in doc.items()}


# ---------------------------------------------------------------------------
# Checkpoint fingerprint (bit-compatible with resilience/checkpoint.py).
# ---------------------------------------------------------------------------


def checkpoint_fingerprint(payload: dict) -> str:
    """sha256 over the compact canonical serialization of a checkpoint
    payload — exactly the historical ``resilience.checkpoint`` scheme,
    so every committed snapshot still validates."""
    return digest(payload, compact=True)


# ---------------------------------------------------------------------------
# Result-store schema identity (the durable memo's code-version key).
# ---------------------------------------------------------------------------


def store_schema_doc() -> dict:
    """The code-version identity of durable result-store rows: the store
    format, the point-key scheme, and the field sets whose shape the
    stored keys and rows depend on (``NoCParams`` feeds the workload
    fingerprints; ``SweepPoint`` is the row shape).  A store written
    under a different document must be refused — its keys or rows are
    not comparable to what the running code would produce."""
    from repro_torch.core.noc.params import NoCParams
    raise NotImplementedError(
        "store_schema_doc needs service.jobs, which is not ported yet "
        "(ROADMAP.md, queue 1 item 2: the next NoC slice)")
    from repro_torch.core.noc.traffic.sweep import SweepPoint

    return {
        "format": {"kind": "repro-noc-result-store", "version": 1},
        "point_key": POINT_KEY_SCHEME,
        "params_fields": [f.name for f in dataclasses.fields(NoCParams)],
        "row_fields": [f.name for f in dataclasses.fields(SweepPoint)],
    }


def store_schema_parts() -> dict:
    """Per-component digests of :func:`store_schema_doc`, written into
    the store header so a mismatch can name *which* component differs
    (mirroring the sweep-journal ``sweep_key_parts`` behavior)."""
    return {k: digest(v, compact=True)
            for k, v in store_schema_doc().items()}


# ---------------------------------------------------------------------------
# Program / compiled-workload identities (the service cache keys).
# ---------------------------------------------------------------------------


def program_fingerprint(prog) -> str:
    """Canonical identity of a :class:`~repro_torch.core.noc.program.Program`:
    sha256 over its schema-v3 JSON serialization (deterministic op
    order, router/fault stamps included)."""
    return hashlib.sha256(prog.to_json().encode()).hexdigest()


def workload_fingerprint(prog, params, engine: str = "heap",
                         mode: str = "barrier") -> str:
    """Identity of one compiled (mesh, params, program, engine) workload
    — the key of the service compile cache and of every memoized
    ``(workload, rate)`` result point.  The mesh rides the program's own
    stamp; ``params`` is normalized via :func:`params_doc`."""
    return digest({
        "kind": "noc-workload",
        "program": program_fingerprint(prog),
        "params": params_doc(params),
        "engine": engine,
        "mode": mode,
    }, compact=True)
