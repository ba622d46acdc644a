"""Declarative job specs for the simulation service.

A job is a JSON document a client submits over the wire; the scheduler
decomposes it into *points* — the memoization granularity — grouped
into *workloads* (everything rate-independent, the compile-cache
granularity).  Three kinds:

``sweep``
    One :func:`~repro_torch.core.noc.traffic.sweep.saturation_sweep`
    invocation: a seeded synthetic population swept over injection
    rates.  One workload; one point per rate.  Rows are
    ``dataclasses.asdict`` of the exact
    :class:`~repro_torch.core.noc.traffic.sweep.SweepPoint` a direct call
    produces (bit-identical: the service executes the same
    compile-once ``measure`` path).

``policy_compare``
    One :func:`~repro_torch.core.noc.traffic.sweep.compare_policies`
    invocation: the same population swept under every
    (routing policy, VC count) configuration.  One workload per
    (policy, VC) row; points are enumerated policy-major, then VC,
    then rate — the direct call's row order.

``run_program``
    One :func:`~repro_torch.core.noc.program.run_program` execution of a
    schema-v3 program document.  One workload with a single point whose
    row carries the makespan, per-phase drain and per-op
    (inject, done) cycles.

Every workload carries a canonical sha256 fingerprint
(:mod:`repro_torch.core.noc.fingerprint`) over (mesh, params, program or
population, engine); a point key appends the rate token.  Identical
submissions from different clients therefore collide in the compile
cache and result memo by construction.

:func:`execute_workload` is the *only* execution path — the worker
processes, the scheduler's in-process degradation mode and the tests
all run chunks through it, so fanned-out and serial results cannot
drift.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

from repro_torch.core.noc.fingerprint import digest, params_doc, params_from_doc
from repro_torch.core.noc.params import NoCParams

JOB_KINDS = ("sweep", "policy_compare", "run_program")

PROGRAM_TOKEN = "result"

# Version tag of the point-key scheme below.  The durable result store
# stamps this into its header (via ``fingerprint.store_schema_parts``):
# bump it if :func:`point_key` ever changes shape, so stores written
# under the old scheme are refused by name instead of silently missing.
POINT_KEY_SCHEME = "workload_fingerprint:json_token/v1"


# ---------------------------------------------------------------------------
# Point/workload decomposition records (scheduler-facing).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WorkloadPoints:
    """One compile-cache unit of a job: a workload document plus the
    ordered tokens (sweep rates, or :data:`PROGRAM_TOKEN`) to evaluate
    on it.  ``meta`` labels the row group (e.g. policy/VC) for clients."""

    doc: dict
    fingerprint: str
    tokens: tuple
    meta: dict

    def point_key(self, token) -> str:
        return point_key(self.fingerprint, token)


def point_key(workload_fingerprint: str, token) -> str:
    """Memo key of one (workload, token) result point."""
    return f"{workload_fingerprint}:{json.dumps(token)}"


# ---------------------------------------------------------------------------
# Job specs.
# ---------------------------------------------------------------------------


def _mesh_pair(mesh) -> tuple[int, int]:
    if hasattr(mesh, "cols"):
        return (mesh.cols, mesh.rows)
    cols, rows = mesh
    return (int(cols), int(rows))


@dataclasses.dataclass(frozen=True)
class SweepJob:
    """Declarative saturation sweep (see
    :func:`~repro_torch.core.noc.traffic.sweep.saturation_sweep`)."""

    mesh: tuple[int, int]
    pattern: str
    rates: tuple[float, ...]
    nbytes: int = 256
    packets_per_node: int = 4
    seed: int = 0
    params: Optional[NoCParams] = None
    engine: str = "heap"
    hotspot: tuple[int, int] = (0, 0)
    hotspot_frac: float = 0.5

    kind = "sweep"

    def __post_init__(self):
        object.__setattr__(self, "mesh", _mesh_pair(self.mesh))
        object.__setattr__(self, "rates", tuple(float(r) for r in self.rates))
        object.__setattr__(self, "hotspot", tuple(self.hotspot))
        if not self.rates:
            raise ValueError("sweep job needs at least one rate")
        if any(r <= 0 for r in self.rates):
            raise ValueError(f"injection rates must be > 0, got {self.rates}")
        from repro_torch.core.noc.traffic.patterns import PATTERNS

        if self.pattern not in PATTERNS:
            raise ValueError(
                f"unknown pattern {self.pattern!r}; one of {PATTERNS}")

    def _population_doc(self, params: Optional[NoCParams] = None,
                        engine: Optional[str] = None) -> dict:
        return {
            "kind": "sweep",
            "mesh": list(self.mesh),
            "pattern": self.pattern,
            "nbytes": self.nbytes,
            "packets_per_node": self.packets_per_node,
            "seed": self.seed,
            "hotspot": list(self.hotspot),
            "hotspot_frac": self.hotspot_frac,
            "params": params_doc(params if params is not None
                                 else self.params),
            "engine": engine or self.engine,
        }

    def to_doc(self) -> dict:
        doc = self._population_doc()
        doc["rates"] = list(self.rates)
        return doc

    @classmethod
    def from_doc(cls, doc: dict) -> "SweepJob":
        return cls(
            mesh=tuple(doc["mesh"]),
            pattern=doc["pattern"],
            rates=tuple(doc["rates"]),
            nbytes=doc.get("nbytes", 256),
            packets_per_node=doc.get("packets_per_node", 4),
            seed=doc.get("seed", 0),
            params=params_from_doc(doc["params"])
            if doc.get("params") is not None else None,
            engine=doc.get("engine", "heap"),
            hotspot=tuple(doc.get("hotspot", (0, 0))),
            hotspot_frac=doc.get("hotspot_frac", 0.5),
        )

    def fingerprint(self) -> str:
        return digest(self.to_doc())

    def workloads(self) -> list[WorkloadPoints]:
        doc = self._population_doc()
        return [WorkloadPoints(doc=doc, fingerprint=digest(doc),
                               tokens=self.rates, meta={})]


@dataclasses.dataclass(frozen=True)
class PolicyCompareJob:
    """Declarative (routing policy x VC count) sweep comparison (see
    :func:`~repro_torch.core.noc.traffic.sweep.compare_policies`)."""

    mesh: tuple[int, int]
    pattern: str
    rates: tuple[float, ...]
    policies: tuple[str, ...] = ("xy", "yx", "o1turn", "oddeven")
    vcs: tuple[int, ...] = (1,)
    vc_select: str = "packet"
    nbytes: int = 256
    packets_per_node: int = 4
    seed: int = 0
    params: Optional[NoCParams] = None
    engine: str = "heap"
    hotspot: tuple[int, int] = (0, 0)
    hotspot_frac: float = 0.5

    kind = "policy_compare"

    def __post_init__(self):
        object.__setattr__(self, "mesh", _mesh_pair(self.mesh))
        object.__setattr__(self, "rates", tuple(float(r) for r in self.rates))
        object.__setattr__(self, "policies", tuple(self.policies))
        object.__setattr__(self, "vcs", tuple(int(v) for v in self.vcs))
        object.__setattr__(self, "hotspot", tuple(self.hotspot))
        if not (self.rates and self.policies and self.vcs):
            raise ValueError(
                "policy_compare job needs rates, policies and vcs")

    def _sweep(self) -> SweepJob:
        return SweepJob(
            mesh=self.mesh, pattern=self.pattern, rates=self.rates,
            nbytes=self.nbytes, packets_per_node=self.packets_per_node,
            seed=self.seed, params=self.params, engine=self.engine,
            hotspot=self.hotspot, hotspot_frac=self.hotspot_frac,
        )

    def to_doc(self) -> dict:
        doc = self._sweep().to_doc()
        doc["kind"] = "policy_compare"
        doc["policies"] = list(self.policies)
        doc["vcs"] = list(self.vcs)
        doc["vc_select"] = self.vc_select
        return doc

    @classmethod
    def from_doc(cls, doc: dict) -> "PolicyCompareJob":
        sweep = SweepJob.from_doc(dict(doc, kind="sweep"))
        return cls(
            mesh=sweep.mesh, pattern=sweep.pattern, rates=sweep.rates,
            policies=tuple(doc["policies"]), vcs=tuple(doc["vcs"]),
            vc_select=doc.get("vc_select", "packet"),
            nbytes=sweep.nbytes, packets_per_node=sweep.packets_per_node,
            seed=sweep.seed, params=sweep.params, engine=sweep.engine,
            hotspot=sweep.hotspot, hotspot_frac=sweep.hotspot_frac,
        )

    def fingerprint(self) -> str:
        return digest(self.to_doc())

    def workloads(self) -> list[WorkloadPoints]:
        """One workload per (policy, VC) row, policy-major — the exact
        row order of ``compare_policies``."""
        base = self.params or NoCParams()
        sweep = self._sweep()
        out = []
        for policy in self.policies:
            for num_vcs in self.vcs:
                p = dataclasses.replace(
                    base, routing=policy, num_vcs=num_vcs,
                    vc_select=self.vc_select)
                doc = sweep._population_doc(params=p)
                out.append(WorkloadPoints(
                    doc=doc, fingerprint=digest(doc), tokens=self.rates,
                    meta={"policy": policy, "num_vcs": num_vcs}))
        return out


@dataclasses.dataclass(frozen=True)
class RunProgramJob:
    """Declarative program execution (see
    :func:`~repro_torch.core.noc.program.run_program`)."""

    program: dict                     # schema-v3 program document
    params: Optional[NoCParams] = None
    mode: str = "op"
    engine: str = "heap"
    max_cycles: int = 50_000_000

    kind = "run_program"

    @classmethod
    def of(cls, prog, params: Optional[NoCParams] = None, mode: str = "op",
           engine: str = "heap", max_cycles: int = 50_000_000):
        """Build from a live :class:`~repro_torch.core.noc.program.Program`."""
        return cls(program=json.loads(prog.to_json()), params=params,
                   mode=mode, engine=engine, max_cycles=max_cycles)

    def to_doc(self) -> dict:
        return {
            "kind": "run_program",
            "program": self.program,
            "params": params_doc(self.params),
            "mode": self.mode,
            "engine": self.engine,
            "max_cycles": self.max_cycles,
        }

    @classmethod
    def from_doc(cls, doc: dict) -> "RunProgramJob":
        return cls(
            program=doc["program"],
            params=params_from_doc(doc["params"])
            if doc.get("params") is not None else None,
            mode=doc.get("mode", "op"),
            engine=doc.get("engine", "heap"),
            max_cycles=doc.get("max_cycles", 50_000_000),
        )

    def fingerprint(self) -> str:
        return digest(self.to_doc())

    def workloads(self) -> list[WorkloadPoints]:
        doc = self.to_doc()
        return [WorkloadPoints(doc=doc, fingerprint=digest(doc),
                               tokens=(PROGRAM_TOKEN,), meta={})]


def job_from_doc(doc: dict):
    """Parse a submitted job document; raises ``ValueError`` on an
    unknown kind or malformed fields."""
    kind = doc.get("kind")
    if kind == "sweep":
        return SweepJob.from_doc(doc)
    if kind == "policy_compare":
        return PolicyCompareJob.from_doc(doc)
    if kind == "run_program":
        return RunProgramJob.from_doc(doc)
    raise ValueError(f"unknown job kind {kind!r}; one of {JOB_KINDS}")


# ---------------------------------------------------------------------------
# Execution: the one path every chunk takes (workers, degraded in-process
# mode and tests alike).
# ---------------------------------------------------------------------------


def _sweep_artifacts(doc: dict, first_rate: float):
    """Compile the rate-independent artifacts of a sweep workload: the
    seeded population and its compiled workload.  Bit-identity with the
    direct sweep does not depend on ``first_rate`` — compiled stream
    specs are start-independent (the compile-once invariant)."""
    from repro_torch.core.noc.program import compile_workload, from_trace
    from repro_torch.core.noc.traffic.patterns import (
        SyntheticConfig,
        synthetic_population,
    )
    from repro_torch.core.topology import Mesh2D

    mesh = Mesh2D(*doc["mesh"])
    params = params_from_doc(doc["params"])
    cfg = SyntheticConfig(
        pattern=doc["pattern"], rate=first_rate, nbytes=doc["nbytes"],
        packets_per_node=doc["packets_per_node"], seed=doc["seed"],
        hotspot=tuple(doc["hotspot"]), hotspot_frac=doc["hotspot_frac"],
    )
    pop = synthetic_population(mesh, cfg)
    compiled = compile_workload(from_trace(pop.trace_at(cfg.rate)),
                                params=params)
    return mesh, params, pop, compiled


def execute_workload(doc: dict, tokens, cache) -> list:
    """Evaluate ``tokens`` on workload ``doc``; returns one JSON-ready
    row per token, in token order.

    ``cache`` is the executing process's :class:`~.cache.CompileCache`;
    sweep workloads cache their (population, CompiledWorkload) pair
    under the workload fingerprint.  Rows are exactly what the direct
    APIs produce (``SweepPoint`` asdict / per-op cycles), so memoized,
    fanned-out and serial results are bit-identical by construction.
    """
    kind = doc.get("kind")
    if kind == "sweep":
        from repro_torch.core.noc.traffic.patterns import SyntheticConfig
        from repro_torch.core.noc.traffic.sweep import measure

        fp = digest(doc)
        mesh, params, pop, compiled = cache.get(
            fp, lambda: _sweep_artifacts(doc, float(tokens[0])))
        rows = []
        for rate in tokens:
            cfg = SyntheticConfig(
                pattern=doc["pattern"], rate=float(rate),
                nbytes=doc["nbytes"],
                packets_per_node=doc["packets_per_node"], seed=doc["seed"],
                hotspot=tuple(doc["hotspot"]),
                hotspot_frac=doc["hotspot_frac"],
            )
            pt = measure(mesh, cfg, params=params, engine=doc["engine"],
                         compiled=compiled, population=pop)
            rows.append(dataclasses.asdict(pt))
        return rows
    if kind == "run_program":
        from repro_torch.core.noc.program import run_program
        from repro_torch.core.noc.program.ops import Program

        prog = Program.from_json(json.dumps(doc["program"]))
        params = params_from_doc(doc["params"])
        res = run_program(prog, params, mode=doc["mode"],
                          engine=doc["engine"],
                          max_cycles=doc["max_cycles"])
        row = {
            "makespan": res.makespan,
            "phase_end": list(res.phase_end),
            "runs": [[r.op.id, r.inject_cycle, r.done_cycle]
                     for r in res.runs],
        }
        return [row for _ in tokens]
    raise ValueError(f"cannot execute workload kind {kind!r}")
