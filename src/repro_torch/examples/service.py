"""Simulation-as-a-service walkthrough: one persistent server, many
cheap clients — and a server you can kill without losing work.

The port's counterpart of ``examples/service.py``, on the port's copy of
``core/noc/service``; it prints the same lines.  Each in-process server is
drained and its accept threads woken before its ``with`` block closes it
(:func:`release`), so that the close does not wait on them.

Core-only (no JAX needed).  Start a :class:`SimulationServer` on a
local socket, then drive it the way a design-space exploration session
actually does: two clients submit overlapping saturation grids
concurrently (the service computes each unique point once and coalesces
the overlap), a third streams rows as chunks complete instead of
waiting for the batch, a resubmission returns instantly from the result
memo, and the point-exact service counters show where every row came
from.  Every row is bit-identical to calling ``saturation_sweep``
directly — the demo asserts it.

Part 2 is the durability story: the same server run as a child process
(:class:`ServerProcess`) with a crash-safe on-disk result store,
``kill -9``'d, restarted on the same store — a warm resubmission is
served from disk (store hits, zero recompute), still bit-identical.

Part 3 shows the TCP transport: the same protocol on ``tcp=(host,
port)`` guarded by a shared token (``hmac.compare_digest`` on the
server; unauthenticated connections are refused before any job
parsing).  Remote use is otherwise identical:

    server = SimulationServer(tcp=("0.0.0.0", 7777), token=SECRET,
                              store="results.jsonl")
    client = ServiceClient((host, 7777), token=SECRET, resume=True)

``resume=True`` additionally survives server restarts mid-job: the
client reconnects with capped exponential backoff and idempotently
resubmits in-flight jobs (row indices dedupe re-deliveries, the job
fingerprint guarantees it is the same job).

  PYTHONPATH=src python -m repro_torch.examples.service
"""

import contextlib
import os
import socket
import tempfile
import threading
import time


GRID = dict(mesh=(8, 8), pattern="transpose",
            rates=[0.02, 0.04, 0.06, 0.08, 0.1, 0.12],
            packets_per_node=4, seed=7)


def release(srv):
    """Drain ``srv`` (its jobs finish, its listeners close) and wake the
    threads blocked in accept() on its listeners with one connection each:
    closing a listening socket does not wake them, and ``close()`` would
    wait 5 s for each.  The listeners are not shut down instead: on some
    hosts ``shutdown(SHUT_RDWR)`` of a listening socket raises ENOTCONN."""
    srv.drain(timeout=30)
    targets = [(socket.AF_UNIX, srv.path)]
    if srv.tcp_address is not None:
        targets.append((socket.AF_INET, tuple(srv.tcp_address)))
    for family, address in targets:
        with contextlib.suppress(OSError), socket.socket(family) as wake:
            wake.connect(address)


def main():
    from repro_torch.core.noc.service import ServiceClient, SimulationServer
    from repro_torch.core.noc.traffic.sweep import saturation_sweep
    from repro_torch.core.topology import Mesh2D

    with SimulationServer(workers=2, chunk_tokens=2) as srv:
        print(f"service listening on {srv.path}")

        # -- two clients, overlapping grids, concurrently ----------------
        results = {}

        def explore(name, extra_rates):
            kw = dict(GRID)
            kw["rates"] = GRID["rates"] + extra_rates
            with ServiceClient(srv.path) as cli:
                t0 = time.perf_counter()
                results[name] = (cli.submit_sweep(**kw).sweep_points(),
                                 time.perf_counter() - t0)

        t_a = threading.Thread(target=explore, args=("alice", [0.14]))
        t_b = threading.Thread(target=explore, args=("bob", [0.16]))
        t_a.start(); t_b.start(); t_a.join(); t_b.join()
        for name, (pts, wall) in results.items():
            print(f"  {name}: {len(pts)} points in {wall:.2f}s "
                  f"(saturation knee region: mean latency "
                  f"{pts[0].mean_latency:.1f} -> {pts[-1].mean_latency:.1f} "
                  f"cycles)")

        # -- streamed rows: act on early points before the grid finishes -
        with ServiceClient(srv.path) as cli:
            h = cli.submit_sweep(**GRID)    # fully overlaps alice's grid
            t0 = time.perf_counter()
            for idx, row in h.iter_rows():
                print(f"  streamed row {idx}: rate {row['rate']:g} -> "
                      f"mean latency {row['mean_latency']:.1f} cycles "
                      f"({(time.perf_counter() - t0) * 1e3:.0f} ms in)")

            # -- warm resubmission: served from the result memo ----------
            t0 = time.perf_counter()
            pts = cli.submit_sweep(**GRID).sweep_points()
            print(f"  warm resubmission: {len(pts)} rows in "
                  f"{(time.perf_counter() - t0) * 1e3:.1f} ms")

            # -- bit-identity with the direct API ------------------------
            direct = saturation_sweep(
                Mesh2D(*GRID["mesh"]), GRID["pattern"], GRID["rates"],
                packets_per_node=GRID["packets_per_node"],
                seed=GRID["seed"])
            assert pts == direct, "service rows must equal the direct call"
            print("  bit-identical to saturation_sweep: OK")

            # -- where did every point come from? ------------------------
            st = cli.stats()
            p = st["points"]
            print(f"  accounting: {p['total']} points requested = "
                  f"{p['computed']} computed + {p['memo_hits']} memo hits "
                  f"+ {p['inflight_joins']} in-flight joins "
                  f"(hit rate {p['hit_rate']:.2f})")
            print(f"  compile cache: {st['compile_cache']}, "
                  f"workers: {st['workers']}, degraded: {st['degraded']}")
        release(srv)

    # -- part 2: kill -9 the server, restart it, lose nothing ------------
    restart_survival_demo()

    # -- part 3: the TCP transport, token-authenticated ------------------
    tcp_demo()


def restart_survival_demo():
    """Submit against a durable store, SIGKILL the server mid-grid,
    restart it on the same store, resubmit warm: the completed points
    come back from disk, the rest compute exactly once."""
    from repro_torch.core.noc.service import ResultStore, ServerProcess, ServiceClient

    print("restart survival:")
    with tempfile.TemporaryDirectory(prefix="svc-demo-") as tmp:
        sock = os.path.join(tmp, "svc.sock")
        store = os.path.join(tmp, "results.jsonl")

        # A server child that SIGKILLs itself after 3 durable points —
        # standing in for a crash / OOM-kill / power event mid-grid.
        srv = ServerProcess(sock, store=store, workers=0, chunk_tokens=1,
                            chaos_kill_server_after=3)
        done = {}

        def submit(label):
            # resume=True: reconnect with backoff, resubmit idempotently.
            with ServiceClient(sock, resume=True, max_retries=60,
                               backoff_base_s=0.05,
                               backoff_cap_s=0.25) as cli:
                h = cli.submit_sweep(**GRID)
                done[label] = h.sweep_points()
                done["stats"] = cli.stats()

        t = threading.Thread(target=submit, args=("pts",))
        t.start()
        code = srv.wait(timeout=300)
        with ResultStore(store) as st:    # server is dead; safe to peek
            durable = len(st)
        print(f"  server killed mid-grid (exit {code}); rows on disk: "
              f"{durable}")

        # Restart on the same socket path and store: the client's retry
        # loop finds it, resubmits, and completes with zero recompute of
        # the points that were already durable.
        with ServerProcess(sock, store=store, workers=0, chunk_tokens=1):
            t.join(timeout=300)
            p = done["stats"]["points"]
            print(f"  resumed and completed: {len(done['pts'])} rows, "
                  f"{p['store_hits']} served from the store, "
                  f"{p['computed']} computed after restart")


def tcp_demo():
    """The same service over TCP with shared-token auth."""
    import socket as socket_mod

    from repro_torch.core.noc.service import ServiceClient, SimulationServer

    print("tcp transport:")
    with SimulationServer(workers=0, tcp=("127.0.0.1", 0),
                          token="demo-secret") as srv:
        host, port = srv.tcp_address
        print(f"  listening on {host}:{port} (and {srv.path})")
        with ServiceClient((host, port), token="demo-secret") as cli:
            small = dict(GRID, rates=GRID["rates"][:2])
            pts = cli.submit_sweep(**small).sweep_points()
            print(f"  authenticated TCP client: {len(pts)} rows")
        # The wrong token is refused before any job document is parsed.
        raw = socket_mod.create_connection((host, port), timeout=10)
        raw.sendall(b'{"op": "auth", "token": "wrong"}\n')
        print(f"  wrong token -> {raw.recv(4096).split()[0].decode()} ...")
        raw.close()
        release(srv)


if __name__ == "__main__":
    main()
