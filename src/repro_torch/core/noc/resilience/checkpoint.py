"""Deterministic checkpoint/restart of a paused :class:`NoCSim` run.

A checkpoint serializes the complete replay state of a sim paused at an
exact cycle boundary (``sim.run(stop_at=C)``): mesh, parameters (faults
included), every stream's structure + arrival lists + completion state +
gate wiring + lowering provenance, and the sim-level mutable counters
(``_rr``, ``_pkt_seq``, atomic-RMW busy frontier, fault counters, per-VC
CDG dependency sets).  :func:`restore` rebuilds a sim for which
``run(start_cycle=C)`` is **bit-identical** — same arrivals, done cycles
and ``_rr`` — to the uninterrupted run, on every engine (the pause/resume
contract in ``engine.py`` guarantees the window arithmetic; the snapshot
guarantees the state).

Format: a single JSON document, ``format = "repro-noc-checkpoint"``,
``version = 1``, fingerprinted with sha256 over its canonical (sorted-key,
no-whitespace) serialization — :meth:`Snapshot.load` refuses a payload
whose fingerprint does not match.  Everything non-JSON is encoded
explicitly and exactly: ``Coord`` as ``[x, y]``, an edge as
``[x1, y1, x2, y2]``, a CDG turn as an edge pair, and every
:class:`~fractions.Fraction` cycle quantity as ``[numerator,
denominator]`` — no floats in the hot quantities, so the round-trip is
exact by construction.  Dicts with non-string keys are stored as
``[key, value]`` pair lists.

Engine-internal caches (unit topology, heap cursors, ``ready_hint``,
``_gate_t0``) are deliberately *not* serialized: they are pure functions
of the serialized state and every engine rebuilds them at run start.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from fractions import Fraction
from typing import Optional

from repro_torch.core.noc.netsim import NoCSim, _StreamState
from repro_torch.core.noc.params import NoCParams
from repro_torch.core.topology import Coord, Mesh2D, MultiAddress

FORMAT = "repro-noc-checkpoint"
VERSION = 1


# -- encoding helpers --------------------------------------------------------


def _enc_frac(v) -> list:
    f = v if isinstance(v, Fraction) else Fraction(v)
    return [f.numerator, f.denominator]


def _dec_frac(v) -> Fraction:
    return Fraction(v[0], v[1])


def _enc_edge(e) -> list:
    (a, b) = e
    return [a.x, a.y, b.x, b.y]


def _dec_edge(v) -> tuple:
    return (Coord(v[0], v[1]), Coord(v[2], v[3]))


def _enc_origin(origin: Optional[tuple]) -> Optional[list]:
    if origin is None:
        return None
    kind = origin[0]
    if kind == "unicast":
        _, src, dst, nbytes = origin
        return [kind, [src.x, src.y], [dst.x, dst.y], nbytes]
    if kind == "multicast":
        _, src, maddr, nbytes = origin
        return [kind, [src.x, src.y],
                [maddr.dst.x, maddr.dst.y, maddr.x_mask, maddr.y_mask],
                nbytes]
    if kind == "reduction":
        _, sources, dst, nbytes, inject_alpha, traffic_class = origin
        return [kind, [[s.x, s.y] for s in sources], [dst.x, dst.y],
                nbytes, inject_alpha, traffic_class]
    if kind == "timed":
        _, at, cycles = origin
        return [kind, [at.x, at.y], cycles]
    raise ValueError(f"unknown stream origin kind {kind!r}")


def _dec_origin(v: Optional[list]) -> Optional[tuple]:
    if v is None:
        return None
    kind = v[0]
    if kind == "unicast":
        return (kind, Coord(*v[1]), Coord(*v[2]), v[3])
    if kind == "multicast":
        dx, dy, xm, ym = v[2]
        return (kind, Coord(*v[1]), MultiAddress(Coord(dx, dy), xm, ym), v[3])
    if kind == "reduction":
        return (kind, tuple(Coord(*s) for s in v[1]), Coord(*v[2]),
                v[3], v[4], v[5])
    if kind == "timed":
        return (kind, Coord(*v[1]), v[2])
    raise ValueError(f"unknown stream origin kind {kind!r}")


def _enc_params(p: NoCParams) -> dict:
    d = dataclasses.asdict(p)
    faults = d.pop("faults", None)
    d["faults"] = p.faults.to_dict() if p.faults is not None else None
    if p.vc_map is not None:
        d["vc_map"] = [list(pair) for pair in p.vc_map]
    return d


def _dec_params(d: dict) -> NoCParams:
    from repro_torch.core.noc.faults.model import FaultSet

    kw = dict(d)
    if kw.get("faults") is not None:
        kw["faults"] = FaultSet.from_dict(kw["faults"])
    if kw.get("vc_map") is not None:
        kw["vc_map"] = tuple(tuple(pair) for pair in kw["vc_map"])
    return NoCParams(**kw)


def _enc_stream(st: _StreamState, index_of: dict) -> dict:
    return {
        "n_beats": st.n_beats,
        "vc": st.vc,
        "done_cycle": st.done_cycle,
        "origin": _enc_origin(st.origin),
        "gates": [index_of[id(g)] for g in st.gates],
        "prereqs": [
            [_enc_edge(e), [_enc_edge(u) for u in ups]]
            for e, ups in st.prereqs.items()
        ],
        "groups": [[_enc_edge(e) for e in g] for g in st.groups],
        "rate": [[_enc_edge(e), _enc_frac(r)] for e, r in st.rate.items()],
        "inject": [
            [_enc_edge(e), _enc_frac(s), _enc_frac(r)]
            for e, (s, r) in st.inject.items()
        ],
        "finals": [_enc_edge(e) for e in st.finals],
        "arrivals": [
            [_enc_edge(e), list(arr)] for e, arr in st.arrivals.items()
        ],
    }


def _dec_stream(d: dict) -> _StreamState:
    st = _StreamState(
        n_beats=d["n_beats"],
        prereqs={
            _dec_edge(e): [_dec_edge(u) for u in ups]
            for e, ups in d["prereqs"]
        },
        groups=[[_dec_edge(e) for e in g] for g in d["groups"]],
        rate={_dec_edge(e): _dec_frac(r) for e, r in d["rate"]},
        inject={
            _dec_edge(e): (_dec_frac(s), _dec_frac(r))
            for e, s, r in d["inject"]
        },
        finals=[_dec_edge(e) for e in d["finals"]],
        arrivals={_dec_edge(e): list(arr) for e, arr in d["arrivals"]},
        done_cycle=d["done_cycle"],
        vc=d["vc"],
    )
    st.origin = _dec_origin(d["origin"])
    return st


def _canonical(payload: dict) -> bytes:
    # Shared canonical form (fingerprint.canonical_json, compact):
    # byte-identical to the historical local implementation, so every
    # committed snapshot still validates.
    from repro_torch.core.noc.fingerprint import canonical_json

    return canonical_json(payload, compact=True)


# -- snapshot ----------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """One checkpoint: the versioned payload plus its sha256 fingerprint
    (computed over the canonical serialization of everything else)."""

    payload: dict
    fingerprint: str

    @property
    def cycle(self) -> int:
        return self.payload["cycle"]

    def to_json(self) -> str:
        doc = dict(self.payload)
        doc["fingerprint"] = self.fingerprint
        return json.dumps(doc, sort_keys=True, indent=None,
                          separators=(",", ":"))

    @classmethod
    def from_json(cls, text: str) -> "Snapshot":
        doc = json.loads(text)
        fp = doc.pop("fingerprint", None)
        if doc.get("format") != FORMAT:
            raise ValueError(
                f"not a {FORMAT} document (format={doc.get('format')!r})")
        if doc.get("version") != VERSION:
            raise ValueError(
                f"unsupported checkpoint version {doc.get('version')!r} "
                f"(this reader handles {VERSION})")
        want = hashlib.sha256(_canonical(doc)).hexdigest()
        if fp != want:
            raise ValueError(
                f"checkpoint fingerprint mismatch: stored {fp!r}, "
                f"recomputed {want[:16]}... — refusing corrupted snapshot")
        return cls(payload=doc, fingerprint=fp)

    def save(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path) -> "Snapshot":
        with open(path) as f:
            return cls.from_json(f.read())


def checkpoint(sim: NoCSim, cycle: int) -> Snapshot:
    """Snapshot ``sim`` paused at the exact boundary ``cycle`` (i.e. after
    ``sim.run(stop_at=cycle, ...)`` returned ``cycle``); ``cycle`` is the
    ``start_cycle`` a restored run must resume with."""
    index_of = {id(st): i for i, st in enumerate(sim.streams)}
    payload = {
        "format": FORMAT,
        "version": VERSION,
        "cycle": cycle,
        "mesh": [sim.mesh.cols, sim.mesh.rows],
        "params": _enc_params(sim.p),
        "sim": {
            "rr": sim._rr,
            "pkt_seq": sim._pkt_seq,
            "atomic_busy_until": sim._atomic_busy_until,
            "fault_counts": dict(sim._fault_counts),
            "fault_deps": [
                [vc, sorted([_enc_edge(a), _enc_edge(b)] for a, b in deps)]
                for vc, deps in sorted(sim._fault_deps.items())
            ],
            "fault_deps_dirty": sim._fault_deps_dirty,
        },
        "streams": [_enc_stream(st, index_of) for st in sim.streams],
    }
    # Optional section, present only when observability is active: a sim
    # without a collector snapshots byte-identically to every pre-telemetry
    # checkpoint (same payload keys, same fingerprint).
    tel = getattr(sim, "telemetry", None)
    if tel is not None:
        payload["telemetry"] = tel.state_dict()
    fp = hashlib.sha256(_canonical(payload)).hexdigest()
    return Snapshot(payload=payload, fingerprint=fp)


def run_with_autocheckpoint(sim: NoCSim, path, interval: int,
                            engine: str = "heap",
                            max_cycles: int = 2_000_000):
    """Run ``sim`` to completion with a periodic on-disk checkpoint, and
    resume from ``path`` when a previous attempt left a snapshot there.

    The run is segmented at ``interval``-cycle boundaries (the
    pause/resume contract: each segment is
    ``run(stop_at=t+interval, start_cycle=t)``); at every boundary the
    paused state is snapshotted and written **atomically** (temp file +
    rename, so a crash mid-write leaves the previous snapshot intact).
    On entry, an existing snapshot at ``path`` is loaded, validated
    (fingerprint) and resumed from — an interrupted long run restarts
    from its last boundary instead of from zero.  The snapshot is
    deleted once the run completes.

    Returns ``(sim, makespan)`` — ``sim`` is the restored instance when
    a snapshot was resumed (the caller's lowered sim is superseded).
    The combined segmented run is bit-identical to an uninterrupted
    ``sim.run(engine=...)`` (the checkpoint guarantee), so
    makespans and stream states are unchanged by checkpointing.  Pick
    ``interval`` coarse relative to snapshot cost to bound the wall
    overhead (``bench_resilience`` measures the overhead curve).
    """
    import os

    if interval < 1:
        raise ValueError(f"interval must be >= 1, got {interval}")
    t = 0
    if os.path.exists(path):
        snap = Snapshot.load(path)
        sim = restore(snap)
        t = snap.cycle
    while True:
        stop = t + interval
        r = sim.run(max_cycles=max_cycles, engine=engine,
                    stop_at=stop, start_cycle=t)
        if r < stop or all(s.done_cycle is not None for s in sim.streams):
            break
        t = stop
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            f.write(checkpoint(sim, t).to_json())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    try:
        os.unlink(path)
    except OSError:
        pass
    return sim, r


def restore(snap: Snapshot) -> NoCSim:
    """Rebuild the paused sim from a snapshot.  Resume it with
    ``sim.run(start_cycle=snap.cycle, ...)`` (any engine); the combined
    run is bit-identical to one that never paused."""
    payload = snap.payload
    mesh = Mesh2D(*payload["mesh"])
    sim = NoCSim(mesh, _dec_params(payload["params"]))
    streams = [_dec_stream(d) for d in payload["streams"]]
    for st, d in zip(streams, payload["streams"]):
        st.gates = [streams[i] for i in d["gates"]]
    sim.streams = streams
    s = payload["sim"]
    sim._rr = s["rr"]
    sim._pkt_seq = s["pkt_seq"]
    sim._atomic_busy_until = s["atomic_busy_until"]
    sim._fault_counts = dict(s["fault_counts"])
    sim._fault_deps = {
        vc: {(_dec_edge(a), _dec_edge(b)) for a, b in deps}
        for vc, deps in s["fault_deps"]
    }
    sim._fault_deps_dirty = s["fault_deps_dirty"]
    if "telemetry" in payload:
        from repro_torch.core.noc.telemetry import Collector

        sim.telemetry = Collector.from_state(payload["telemetry"])
    return sim
