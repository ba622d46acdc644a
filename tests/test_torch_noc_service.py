"""The port's simulation service against the reference's.

``repro_torch.core.noc.service`` is the port's copy of the reference's job
specs, compile cache and result memo, durable result store, supervised
scheduler and socket server and client.  It keeps the reference's store tag
(``repro-noc-result-store``) and point-key scheme, so a store written by
either package opens in the other.  Job documents, fingerprints, rows and
store files are compared exactly; sweep rows, which are dataclasses of
different classes in the two packages, compare as ``dataclasses.asdict``.
A server forks at most 2 workers and listens on a Unix socket in its own
temporary directory.
"""

import contextlib
import dataclasses
import json
import socket

import pytest

from test_torch_noc_program import PKGS, _both, _doc, _m

GRID = {"mesh": (4, 4), "pattern": "transpose", "rates": [0.02, 0.04, 0.06, 0.08, 0.1, 0.12],
        "packets_per_node": 2, "seed": 7}


def _svc(pkg):
    return _m(pkg, "core.noc.service")


def _program(pkg):
    topo = _m(pkg, "core.topology")
    b = _m(pkg, "core.noc.program").ProgramBuilder(topo.Mesh2D(4, 4))
    b.unicast((0, 0), (3, 3), 4096)
    b.barrier()
    b.reduction([(0, 0), (3, 0)], (3, 3), 1024)
    b.compute((1, 1), cycles=40.0)
    return b.build()


def _jobs(pkg):
    svc = _svc(pkg)
    P = _m(pkg, "core.noc.params").NoCParams
    return [
        svc.SweepJob(mesh=(6, 4), pattern="hotspot", rates=(0.02, 0.05), seed=3,
                     hotspot=(2, 1), hotspot_frac=0.8, params=P(routing="yx", num_vcs=2)),
        svc.SweepJob(**{**GRID, "rates": tuple(GRID["rates"][:3])}),
        svc.PolicyCompareJob(mesh=(4, 4), pattern="transpose", rates=(0.02, 0.08),
                             policies=("xy", "yx"), vcs=(1, 2), packets_per_node=2, seed=4),
        svc.RunProgramJob.of(_program(pkg), mode="op"),
        svc.RunProgramJob.of(_program(pkg), params=P(routing="o1turn", num_vcs=2),
                             mode="window"),
    ]


def _points_doc(job) -> list:
    return [[w.doc, w.fingerprint, list(w.tokens), w.meta,
             [w.point_key(t) for t in w.tokens]] for w in job.workloads()]


@pytest.mark.parametrize("i", range(5))
def test_job_documents_and_fingerprints_parity(i):
    def doc(pkg):
        job = _jobs(pkg)[i]
        again = _svc(pkg).job_from_doc(json.loads(json.dumps(job.to_doc())))
        assert again.fingerprint() == job.fingerprint()
        return _doc([job.kind, job.to_doc(), job.fingerprint(), _points_doc(job)])

    ref, port = _both(doc)
    assert port == ref


@pytest.mark.parametrize("i", range(5))
def test_reference_job_document_parses_in_the_port(i):
    job = _jobs("repro")[i]
    again = _svc("repro_torch").job_from_doc(json.loads(json.dumps(job.to_doc())))
    assert again.fingerprint() == job.fingerprint()
    assert _doc(_points_doc(again)) == _doc(_points_doc(job))


@pytest.mark.parametrize("i", range(5))
def test_execute_workload_parity(i):
    def rows(pkg):
        svc = _svc(pkg)
        return _doc([svc.execute_workload(json.loads(json.dumps(w.doc)), w.tokens,
                                          svc.CompileCache())
                     for w in _jobs(pkg)[i].workloads()])

    ref, port = _both(rows)
    assert port == ref


def test_execute_workload_matches_the_reference_direct_sweep():
    direct = _m("repro", "core.noc.traffic.sweep").saturation_sweep(
        _m("repro", "core.topology").Mesh2D(4, 4), "transpose", (0.02, 0.06, 0.1),
        packets_per_node=2, seed=3)
    svc = _svc("repro_torch")
    [wl] = svc.SweepJob(mesh=(4, 4), pattern="transpose", rates=(0.02, 0.06, 0.1),
                        packets_per_node=2, seed=3).workloads()
    assert (svc.execute_workload(json.loads(json.dumps(wl.doc)), wl.tokens, svc.CompileCache())
            == [dataclasses.asdict(p) for p in direct])


def test_store_schema_parity():
    ref, port = _both(lambda pkg: _doc([_m(pkg, "core.noc.fingerprint").store_schema_doc(),
                                        _m(pkg, "core.noc.fingerprint").store_schema_parts()]))
    assert port == ref
    assert json.loads(port)[0]["format"]["kind"] == "repro-noc-result-store"


def _rows_of(pkg, n: int) -> dict:
    svc = _svc(pkg)
    rows = {}
    for job in _jobs(pkg)[:n]:
        for w in job.workloads():
            out = svc.execute_workload(w.doc, w.tokens, svc.CompileCache())
            rows.update({w.point_key(t): r for t, r in zip(w.tokens, out)})
    return rows


@pytest.mark.parametrize("writer,reader", (PKGS, PKGS[::-1]), ids=("ref-to-port", "port-to-ref"))
def test_store_file_opens_in_the_other_package(tmp_path, writer, reader):
    path = str(tmp_path / "rs.jsonl")
    rows = _rows_of(writer, 3)
    with _svc(writer).ResultStore(path) as st:
        for k, r in rows.items():
            st.append(k, r)
    text = open(path).read()
    other = _svc(reader).ResultStore(path)
    try:
        assert _doc(other.rows()) == _doc(rows)
        assert other.rows_loaded == len(rows) and other.torn_dropped == 0
    finally:
        other.close()
    assert open(path).read() == text  # nothing to compact, nothing rewritten


def test_store_files_written_alike(tmp_path):
    def write(pkg):
        path = str(tmp_path / f"{pkg}.jsonl")
        with _svc(pkg).ResultStore(path) as st:
            for k, r in _rows_of(pkg, 2).items():
                st.append(k, r)
        return open(path).read()

    ref, port = _both(write)
    assert port == ref


def test_mismatched_store_refused_alike(tmp_path):
    path = str(tmp_path / "rs.jsonl")
    _svc("repro").ResultStore(path).close()
    with open(path) as f:
        header, rest = f.read().split("\n", 1)
    doc = json.loads(header)
    doc["parts"]["row_fields"] = "0" * 64
    with open(path, "w") as f:
        f.write(json.dumps(doc) + "\n" + rest)
    msgs = []
    for pkg in PKGS:
        with pytest.raises(_svc(pkg).StoreMismatch, match="SweepPoint row fields") as exc:
            _svc(pkg).ResultStore(path)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# The port's server and client
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _server(pkg, **kw):
    """A SimulationServer that is drained and closed on exit.  The drain
    closes the listening socket, which does not wake the server's thread
    blocked in accept() on it (close() would wait 5 s for it); a connection
    made after the drain wakes it."""
    srv = _svc(pkg).SimulationServer(chunk_tokens=3, **kw)
    try:
        yield srv
    finally:
        final = srv.drain(timeout=60)
        with contextlib.suppress(OSError), socket.socket(socket.AF_UNIX) as wake:
            wake.connect(srv.path)
        srv.close()
        assert final["jobs"]["submitted"] == final["jobs"]["done"]


def _direct():
    """The reference's own saturation sweep of ``GRID``, as row documents."""
    pts = _m("repro", "core.noc.traffic.sweep").saturation_sweep(
        _m("repro", "core.topology").Mesh2D(*GRID["mesh"]), GRID["pattern"], GRID["rates"],
        packets_per_node=GRID["packets_per_node"], seed=GRID["seed"])
    return [dataclasses.asdict(p) for p in pts]


def _sweep(pkg, srv):
    with _svc(pkg).ServiceClient(srv.path) as cli:
        pts = cli.submit_sweep(**GRID).sweep_points()
        return [dataclasses.asdict(p) for p in pts], cli.stats()


def test_port_server_sweep_matches_the_reference_and_memoizes(tmp_path):
    """Cold on 2 fork workers: the reference's direct sweep; warm: all memo
    hits.  The store then holds the reference's bytes for the same rows."""
    direct = _direct()
    with _server("repro_torch", workers=2, store=str(tmp_path / "rs.jsonl")) as srv:
        cold, _ = _sweep("repro_torch", srv)
        warm, st = _sweep("repro_torch", srv)
    assert cold == warm == direct
    pts = st["points"]
    assert (pts["total"], pts["computed"], pts["memo_hits"]) == (12, 6, 6)
    assert st["workers"] == 2 and not st["degraded"] and st["worker_respawns"] == 0
    assert st["store"]["appends"] == 6


@pytest.mark.parametrize("writer,reader", (PKGS, PKGS[::-1]), ids=("ref-to-port", "port-to-ref"))
def test_fresh_server_serves_the_other_packages_store(tmp_path, writer, reader):
    path = str(tmp_path / "rs.jsonl")
    direct = _direct()
    with _server(writer, workers=0, store=path) as srv:
        cold, st = _sweep(writer, srv)
    assert cold == direct and st["points"]["computed"] == 6
    with _server(reader, workers=0, store=path) as srv:
        warm, st = _sweep(reader, srv)
    assert warm == direct
    pts = st["points"]
    assert (pts["store_hits"], pts["computed"], pts["total"]) == (6, 0, 6)


def test_program_and_policy_jobs_over_the_wire_match_the_reference():
    svc = _svc("repro_torch")
    ref_prog = _m("repro", "core.noc.program").run_program(_program("repro"), None, mode="op")
    kw = {"pattern": "transpose", "rates": [0.02, 0.08], "policies": ("xy", "yx"),
          "vcs": (1,), "packets_per_node": 2, "seed": 4}
    ref_sweeps = _m("repro", "core.noc.traffic.sweep").compare_policies(
        _m("repro", "core.topology").Mesh2D(4, 4), **kw)
    with _server("repro_torch", workers=0) as srv:
        with svc.ServiceClient(srv.path) as cli:
            row = cli.submit_program(_program("repro_torch"), mode="op").result()
            sweeps = cli.submit_policy_compare(mesh=(4, 4), **kw).policy_sweeps()
    assert row["makespan"] == ref_prog.makespan
    assert row["runs"] == [[r.op.id, r.inject_cycle, r.done_cycle] for r in ref_prog.runs]
    assert _doc([dataclasses.asdict(s) for s in sweeps]) == \
        _doc([dataclasses.asdict(s) for s in ref_sweeps])
