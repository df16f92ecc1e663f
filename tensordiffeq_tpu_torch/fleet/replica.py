"""Replicated serving plane: a fleet of fleets behind one front door.

Counterpart of the JAX package's ``fleet/replica.py``.  The wire codec and
the rendezvous hash are the JAX package's byte for byte, so a JAX client
and a port replica agree on the wire and on placement.  Every replica
process creates its own CUDA context on the card (``--device``, the card
by default); a respawned one needs about 13 s to reach CUDA before its
warm start, which the heartbeat timeout and the readiness wait allow for.

One :class:`~tensordiffeq_tpu_torch.fleet.FleetRouter` process dying takes
every tenant's queries with it; this module replicates the serving
plane as the cluster supervisor does the training plane:

* a **ReplicaGroup** runs N replica worker processes, each a full
  :class:`FleetRouter` serving the complete tenant set warm-started from
  the shared artifact directory (zero request-time captures).  The
  :class:`~tensordiffeq_tpu_torch.resilience.ClusterSupervisor` supervises them in its serving-plane
  ``relaunch_scope="worker"`` mode: progress heartbeats become
  liveness+readiness beats (queue depth, loaded tenants, last-flush
  age), a stale beat or non-0 exit is a lost replica, and the relaunch
  respawns ONLY that slot in place — its peers keep serving untouched.
* a **ReplicaServer** wraps one worker's router behind stdlib HTTP
  (the collector's pattern): ``POST /query`` (base64-exact arrays —
  chaos-off replicated serving is bit-identical to a direct router),
  ``POST /drain`` / ``POST /shutdown`` (every in-flight
  :class:`~tensordiffeq_tpu_torch.serving.PendingQuery` completes before the
  worker exits — ``hot_swap``'s zero-dropped-waiter contract applied to
  a process), ``GET /healthz`` / ``GET /metrics``.  A beat thread
  publishes the heartbeat AND an atomic ``metrics.live.json`` registry
  snapshot, so the fleet collector scrapes a replica's counters while it
  is alive, not just after its RunLogger finalizes.
* a **FrontRouter** hashes tenants onto replicas with RENDEZVOUS hashing
  — each (tenant, replica) pair gets an order-free hash weight and the
  tenant routes to its top-weighted live replica, so losing one replica
  remaps only that replica's ~1/N of tenants (consistent-hash bound)
  while everyone else's routes are untouched.  It owns the
  request-level robustness ladder: a per-replica
  :class:`~tensordiffeq_tpu_torch.resilience.CircuitBreaker` (transport
  failures only — a tenant's own breaker opening on a replica must
  never open the replica's) with
  :class:`~tensordiffeq_tpu_torch.resilience.RetryPolicy` failover to the next
  hash candidate, deadline-bounded sweeps, opt-in hedged retries for
  tail tolerance, and graceful degradation below quorum (the
  :class:`~tensordiffeq_tpu_torch.fleet.AdmissionController` watermarks
  tighten via :meth:`AdmissionController.degrade`).

The liveness/reachability split is deliberate: the supervisor's beats
see a DEAD or HUNG replica (process-level), the front router's breaker
sees an UNREACHABLE one (the chaos ``replica_net_partition`` case —
alive, beating, dropping requests).  Both paths are chaos-drilled in
``tests/test_torch_replica.py``; ``chip_smoke.py``'s fleet phase prices
the failover on the card (p50/p99, zero lost requests, respawn wall).
"""

from __future__ import annotations

import base64
import hashlib
import http.client
import http.server
import json
import os
import socket
import sys
import threading
import time
import urllib.parse
from typing import Callable, Optional, Sequence

import numpy as np

from ..resilience.breaker import CircuitBreaker, CircuitOpenError
from ..resilience.chaos import active_chaos
from ..resilience.cluster import ClusterSupervisor, beat, free_port
from ..resilience.retry import RetryPolicy
from ..serving.batcher import RequestTimeout
from ..telemetry import default_registry, log_event
from ..telemetry.collector import SNAPSHOT_FILE
from ..telemetry.slo import to_prometheus
from ..telemetry.tracing import active_tracer
from .admission import AdmissionController, AdmissionRejected


# -------------------------------------------------------------------------- #
# wire codecs: exact-bytes arrays over JSON
# -------------------------------------------------------------------------- #
def encode_array(arr) -> dict:
    """An array as ``{"b64", "dtype", "shape"}`` — base64 of the raw
    bytes, NOT a decimal rendering, so a round-trip is bit-exact (the
    chaos-off replicated serve must be bit-identical to a direct
    router)."""
    a = np.ascontiguousarray(np.asarray(arr))
    return {"b64": base64.b64encode(a.tobytes()).decode("ascii"),
            "dtype": str(a.dtype), "shape": list(a.shape)}


def decode_array(block: dict) -> np.ndarray:
    """Inverse of :func:`encode_array` (a writable copy — ``frombuffer``
    alone would alias the decode buffer read-only)."""
    a = np.frombuffer(base64.b64decode(block["b64"]),
                      dtype=np.dtype(str(block["dtype"])))
    return a.reshape([int(s) for s in block["shape"]]).copy()


def _encode_result(result) -> dict:
    if isinstance(result, tuple):
        return {"tuple": [encode_array(r) for r in result]}
    return encode_array(result)


def _decode_result(block: dict):
    if "tuple" in block:
        return tuple(decode_array(b) for b in block["tuple"])
    return decode_array(block)


# -------------------------------------------------------------------------- #
# errors
# -------------------------------------------------------------------------- #
class ReplicaUnavailable(RuntimeError):
    """Every hash candidate was down, breaker-open, or out of deadline —
    the front router exhausted its failover ladder.  ``trail`` records
    what each attempt saw (for the incident report)."""

    trace_id = None

    def __init__(self, tenant: str, trail: Sequence[str] = ()):
        self.tenant = str(tenant)
        self.trail = tuple(str(t) for t in trail)
        super().__init__(
            f"no replica could serve tenant {tenant!r}: "
            + ("; ".join(self.trail) if self.trail else "no candidates"))


class ReplicaRequestError(RuntimeError):
    """A replica answered with a structured non-retryable failure the
    front router has no richer type for (HTTP 500 relay).  The replica
    is HEALTHY — transport worked — so this never counts against its
    breaker."""

    trace_id = None

    def __init__(self, replica: str, status: int, detail: str):
        self.replica = str(replica)
        self.status = int(status)
        super().__init__(
            f"replica {replica!r} failed the request (HTTP {status}): "
            f"{detail}")


class _ReplicaCallError(Exception):
    """Private transport-level marker: connection refused/reset/dropped,
    malformed response, or an explicit drain — the retryable class that
    DOES count against the replica's breaker and triggers failover."""


def _http_json(method: str, base_url: str, path: str,
               payload: Optional[dict] = None,
               timeout: float = 10.0) -> tuple:
    """One stdlib-HTTP JSON exchange: ``(status, parsed_body)``.
    Transport failures raise ``OSError`` / ``http.client.HTTPException``
    — the caller maps them (the front router onto its breaker)."""
    u = urllib.parse.urlsplit(str(base_url))
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=timeout)
    try:
        body = None if payload is None else json.dumps(payload).encode()
        headers = {"Content-Type": "application/json"} if body else {}
        conn.request(method, path, body=body, headers=headers)
        resp = conn.getresponse()
        data = resp.read()
        try:
            parsed = json.loads(data.decode("utf-8")) if data else {}
        except (UnicodeDecodeError, json.JSONDecodeError):
            parsed = {}
        return resp.status, parsed
    finally:
        conn.close()


# -------------------------------------------------------------------------- #
# the replica worker: one FleetRouter behind HTTP + liveness beats
# -------------------------------------------------------------------------- #
class ReplicaServer:
    """One replica: a :class:`FleetRouter` served over stdlib HTTP with
    liveness+readiness beats (see module docstring).

    The router (and its batchers) is single-threaded by design, so every
    router touch from the concurrent HTTP handler threads serializes
    under one lock — the coalescing window, not the lock, stays the
    batching mechanism.  The replica serves on its router's device (the
    card unless the router was built with ``device="cpu"``).

    Endpoints: ``POST /query`` (``{"tenant", "kind", "x": enc[,
    "priority"]}`` → ``{"ok": true, "result": enc}`` or a structured
    error body — 429 admission, 503 tenant-breaker/draining, 504
    deadline, 404 unknown tenant), ``POST /drain`` (flush + fail-fast
    all pending; the replica rejects queries afterwards), ``POST
    /shutdown`` (drain, answer, then exit 0), ``GET /ping`` /
    ``/healthz`` / ``/metrics``.
    """

    def __init__(self, router, *, rank: int = 0, port: int = 0,
                 addr: str = "127.0.0.1", run_dir: Optional[str] = None,
                 beat_interval_s: float = 0.5, tracer=None, registry=None):
        self.router = router
        self.rank = int(rank)
        self.addr = str(addr)
        self.port = int(port)
        self.run_dir = None if run_dir is None else str(run_dir)
        self.beat_interval_s = float(beat_interval_s)
        self.tracer = tracer
        self._registry = (registry if registry is not None
                          else router._registry)
        self._lock = threading.Lock()
        self._done = threading.Event()
        self._draining = False
        self._n_requests = 0
        self._last_flush_wall: Optional[float] = None
        self._httpd = None
        self._http_thread = None
        self._beat_thread = None

    # ------------------------------------------------------------------ #
    def handle_query(self, payload: dict) -> tuple:
        """One query: ``(status, body)`` — or ``(None, None)`` when chaos
        says this replica is partitioned and the connection must drop
        unanswered (the fault liveness beats cannot see)."""
        with self._lock:
            self._n_requests += 1
            n = self._n_requests
        ch = active_chaos()
        if ch is not None and ch.on_replica_request(n, rank=self.rank):
            return None, None
        if self._draining:
            return 503, {"error": "draining", "rank": self.rank}
        self._registry.counter("fleet.replica.requests").inc()
        try:
            tenant = payload["tenant"]
            kind = payload.get("kind", "u")
            X = decode_array(payload["x"])
            with self._lock:
                result = self.router.query(
                    tenant, X, kind=kind, priority=payload.get("priority"))
                self._last_flush_wall = time.time()
            return 200, {"ok": True, "result": _encode_result(result)}
        except AdmissionRejected as e:
            return 429, {"error": "AdmissionRejected", "tenant": e.tenant,
                         "reason": e.reason,
                         "retry_after_s": e.retry_after_s}
        except CircuitOpenError as e:
            return 503, {"error": "CircuitOpenError", "breaker": e.breaker,
                         "retry_after_s": e.retry_after_s}
        except RequestTimeout as e:
            return 504, {"error": "RequestTimeout", "waited_s": e.waited_s}
        except KeyError as e:
            return 404, {"error": "KeyError", "detail": str(e)}
        except Exception as e:
            return 500, {"error": type(e).__name__, "detail": str(e)}

    def drain(self) -> int:
        """Flush + fail-fast everything pending and refuse new queries
        from here on (the worker's half of the drain-before-exit
        contract).  Returns the pending points outstanding at entry."""
        with self._lock:
            self._draining = True
            return self.router.drain()

    def readiness(self) -> dict:
        with self._lock:
            return {"ok": True, "ready": not self._draining,
                    "rank": self.rank, "draining": self._draining,
                    "tenants": list(self.router.loaded()),
                    "pending_points": self.router.pending_points(),
                    "requests": self._n_requests}

    # ------------------------------------------------------------------ #
    def _beat_once(self) -> None:
        with self._lock:
            pending = self.router.pending_points()
            loaded = len(self.router.loaded())
            n = self._n_requests
            last = self._last_flush_wall
        age = -1.0 if last is None else time.time() - last
        # liveness+readiness beat: the supervisor reads the mtime, humans
        # tailing the dir read the payload.  NO spaces inside the phase —
        # the supervisor's sampler whitespace-splits the beat line.
        beat(f"serve[q={pending},t={loaded},flush={age:.1f}]", n)
        self._write_live_metrics()

    def _write_live_metrics(self) -> None:
        """Atomically publish the live registry snapshot the fleet
        collector prefers over a not-yet-final manifest."""
        if self.run_dir is None:
            return
        tmp = os.path.join(self.run_dir, SNAPSHOT_FILE + ".tmp")
        try:
            with open(tmp, "w") as fh:
                json.dump({"metrics": self._registry.as_dict()}, fh)
            os.replace(tmp, os.path.join(self.run_dir, SNAPSHOT_FILE))
        except (OSError, TypeError, ValueError):
            pass  # a failing snapshot must never kill serving

    def _beat_loop(self) -> None:
        while not self._done.is_set():
            self._beat_once()
            self._done.wait(self.beat_interval_s)
        self._beat_once()  # final beat + snapshot before exit

    # ------------------------------------------------------------------ #
    def serve(self) -> str:
        """Start the HTTP endpoint + beat thread; returns the URL."""
        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def _send(self, code: int, body: dict,
                      raw: Optional[bytes] = None,
                      ctype: str = "application/json"):
                data = (raw if raw is not None
                        else (json.dumps(body) + "\n").encode("utf-8"))
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                ch = active_chaos()
                if ch is not None and ch.replica_partition_active():
                    self.close_connection = True
                    return  # partitioned: unreachable, not unhealthy
                if path == "/ping":
                    self._send(200, {"ok": True, "rank": server.rank})
                elif path == "/healthz":
                    self._send(200, server.readiness())
                elif path == "/metrics":
                    self._send(200, {}, raw=to_prometheus(
                        server._registry).encode("utf-8"),
                        ctype="text/plain; version=0.0.4; charset=utf-8")
                else:
                    self._send(404, {"error": "not_found", "path": path})

            def do_POST(self):
                path = self.path.split("?", 1)[0]
                length = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(length) if length else b""
                try:
                    payload = json.loads(raw.decode("utf-8")) if raw else {}
                except (UnicodeDecodeError, json.JSONDecodeError):
                    self._send(400, {"error": "bad_json"})
                    return
                if path == "/query":
                    code, body = server.handle_query(payload)
                    if code is None:  # chaos partition: drop unanswered
                        self.close_connection = True
                        return
                    self._send(code, body)
                elif path == "/drain":
                    self._send(200, {"ok": True,
                                     "drained_points": server.drain()})
                elif path == "/shutdown":
                    n = server.drain()
                    self._send(200, {"ok": True, "drained_points": n})
                    server._done.set()  # answered first, THEN exit
                else:
                    self._send(404, {"error": "not_found", "path": path})

            def log_message(self, *args):
                pass  # replica stdout stays clean for the log files

        self._httpd = http.server.ThreadingHTTPServer(
            (self.addr, self.port), Handler)
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="tdq-replica",
            daemon=True)
        self._http_thread.start()
        self._beat_thread = threading.Thread(
            target=self._beat_loop, name="tdq-replica-beat", daemon=True)
        self._beat_thread.start()
        log_event("replica", f"replica rank {self.rank} serving "
                  f"{len(self.router.tenants())} tenant(s) at {self.url}",
                  verbose=False, rank=self.rank, url=self.url)
        return self.url

    @property
    def url(self) -> Optional[str]:
        if self._httpd is None:
            return None
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until a ``/shutdown`` (or :meth:`close`)."""
        return self._done.wait(timeout)

    def close(self) -> None:
        self._done.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        for t in (self._http_thread, self._beat_thread):
            if t is not None:
                t.join(timeout=5.0)
        self._http_thread = self._beat_thread = None

    def __enter__(self) -> "ReplicaServer":
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# -------------------------------------------------------------------------- #
# the worker entry point (python -m tensordiffeq_tpu_torch.fleet.replica)
# -------------------------------------------------------------------------- #
def main(argv: Optional[Sequence[str]] = None) -> None:
    """Replica worker: import the bootstrap (``module:callable`` →
    :class:`FleetRouter`, called with ``device=`` from ``--device``, the
    card by default), preload EVERY registered tenant (warm start —
    the first beat only happens once the replica can answer its first
    query with zero request-time captures), then serve until
    ``/shutdown``.  Runs under a RunLogger + env-inherited Tracer so its
    spans join the supervisor's stitched trace."""
    import argparse
    import importlib

    from ..utils import resolve_device

    p = argparse.ArgumentParser(prog="tensordiffeq_tpu_torch.fleet.replica")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--bootstrap", required=True,
                   help="module:callable(device=) returning a registered "
                   "FleetRouter")
    p.add_argument("--run-dir", default=None)
    p.add_argument("--beat-interval", type=float, default=0.5)
    p.add_argument("--device", default="cuda",
                   help="where the replica serves (default: the card)")
    args = p.parse_args(argv)

    mod_name, sep, fn_name = args.bootstrap.partition(":")
    if not sep or not fn_name:
        raise ValueError(
            f"--bootstrap must be module:callable, got {args.bootstrap!r}")
    router = getattr(importlib.import_module(mod_name), fn_name)(
        device=resolve_device(args.device))

    gen = os.environ.get("TDQ_CLUSTER_GENERATION", "0")
    run_dir = args.run_dir or os.path.join(
        os.getcwd(), f"replica{args.rank}.gen{gen}")

    from ..telemetry.runlog import RunLogger
    from ..telemetry.tracing import Tracer
    with RunLogger(run_dir, config={"rank": args.rank, "port": args.port,
                                    "generation": gen},
                   registry=router._registry) as lg:
        tracer = Tracer.from_env(logger=lg, registry=router._registry)
        with tracer:
            for t in router.tenants():
                router.load(t)  # warm start BEFORE the first beat
            server = ReplicaServer(
                router, rank=args.rank, port=args.port, run_dir=run_dir,
                beat_interval_s=args.beat_interval, tracer=tracer)
            server.serve()
            server.wait()
            server.close()


# -------------------------------------------------------------------------- #
# the replica group: ClusterSupervisor repurposed for serving
# -------------------------------------------------------------------------- #
class ReplicaGroup:
    """N replica workers under a serving-mode
    :class:`~tensordiffeq_tpu_torch.resilience.ClusterSupervisor`
    (``relaunch_scope="worker"``: a lost replica is respawned in place
    while its peers keep serving).

    Ports are allocated ONCE per slot and pinned across relaunches, so a
    respawned replica comes back at the same endpoint and the front
    router's breaker simply half-opens back into it — no re-discovery.

    Args:
      bootstrap: ``module:callable`` importable IN THE WORKER that,
        called with ``device=``, returns a registered
        :class:`FleetRouter` on that device (artifact paths must be
        absolute or resolvable from ``workdir`` — the workers run
        there).
      nproc: replica count.
      workdir: heartbeat files, worker logs and per-replica run dirs
        (``replica<r>.gen<g>``) land here.
      heartbeat_timeout_s: stale-beat bound; must exceed the worker's
        startup (imports, reaching CUDA — about 13 s on the card —
        artifact load and warm start) since beats only start once the
        replica can serve.
      env: extra worker environment (e.g. ``PYTHONPATH`` for the
        bootstrap module, or a ``TDQ_CHAOS`` spec).
      device: where the replicas serve, passed on each worker's argv
        (``--device``): the card (``"cuda"``, the default; raises
        :class:`~tensordiffeq_tpu_torch.utils.CudaUnavailableError`
        without one) unless the caller passes ``"cpu"``.  Each replica
        process makes its own CUDA context on the card.
    """

    def __init__(self, bootstrap: str, nproc: int = 2,
                 workdir: str = "replicas", *,
                 heartbeat_timeout_s: float = 120.0,
                 max_relaunches: int = 2, beat_interval_s: float = 0.5,
                 poll_s: float = 0.2, env: Optional[dict] = None,
                 tracer=None, registry=None, verbose: bool = False,
                 device="cuda"):
        from ..utils import resolve_device
        self.device = resolve_device(device)
        self.bootstrap = str(bootstrap)
        self.nproc = int(nproc)
        self.workdir = str(workdir)
        os.makedirs(self.workdir, exist_ok=True)
        self.ports = [free_port() for _ in range(self.nproc)]
        self.registry = (registry if registry is not None
                         else default_registry())
        beat_iv = float(beat_interval_s)

        def worker_cmd(pid: int, nproc_: int, port_: int) -> list:
            # the supervisor's per-generation port is for collective
            # jobs; replicas pin their slot's stable port instead.  -c
            # instead of -m: the fleet package imports this module, so
            # runpy's -m re-execution would warn about the double import.
            return [sys.executable, "-c",
                    "from tensordiffeq_tpu_torch.fleet.replica import main; "
                    "main()",
                    "--rank", pid, "--port", self.ports[pid],
                    "--bootstrap", self.bootstrap,
                    "--beat-interval", beat_iv,
                    "--device", self.device.type]

        self.supervisor = ClusterSupervisor(
            worker_cmd, self.nproc, self.workdir,
            heartbeat_timeout_s=heartbeat_timeout_s, poll_s=poll_s,
            grace_s=5.0, max_relaunches=max_relaunches, min_hosts=1,
            env=env, tracer=tracer, registry=self.registry,
            verbose=verbose, relaunch_scope="worker")
        self.collector = None  # set by serve_metrics
        self._pool = None
        self._future = None

    # ------------------------------------------------------------------ #
    def endpoints(self) -> dict:
        """``{replica_name: base_url}`` — the FrontRouter's input."""
        return {f"replica{i}": f"http://127.0.0.1:{p}"
                for i, p in enumerate(self.ports)}

    def run_dirs(self) -> list:
        """Every per-replica run dir (all generations), for trace
        stitching and collector tails — includes dirs that do not exist
        YET (future relaunch generations), which both consumers
        tolerate."""
        return [os.path.join(self.workdir, f"replica{r}.gen{g}")
                for r in range(self.nproc)
                for g in range(self.supervisor.max_relaunches + 1)]

    def start(self, timeout_s: float = 600.0) -> None:
        """Launch the group (the supervisor loop runs on a worker
        thread; :meth:`shutdown` joins it)."""
        from concurrent.futures import ThreadPoolExecutor
        self._pool = ThreadPoolExecutor(1)
        self._future = self._pool.submit(self.supervisor.run, timeout_s)

    def wait_ready(self, timeout_s: float = 120.0,
                   min_replicas: Optional[int] = None) -> dict:
        """Block until ``min_replicas`` (default: all) answer
        ``/healthz`` ready; returns ``{name: readiness}``.  Raises the
        supervisor's failure immediately if the group died first."""
        need = self.nproc if min_replicas is None else int(min_replicas)
        deadline = time.monotonic() + float(timeout_s)
        eps = self.endpoints()
        while True:
            if self._future is not None and self._future.done():
                self._future.result()  # surfaces HostLost etc.
                raise ReplicaUnavailable(
                    "*", [f"supervisor exited before {need} replica(s) "
                          "became ready"])
            ready = {}
            for name, url in eps.items():
                try:
                    status, body = _http_json("GET", url, "/healthz",
                                              timeout=2.0)
                except (OSError, http.client.HTTPException):
                    continue
                if status == 200 and body.get("ready"):
                    ready[name] = body
            if len(ready) >= need:
                return ready
            if time.monotonic() > deadline:
                raise ReplicaUnavailable(
                    "*", [f"only {len(ready)}/{need} replica(s) ready "
                          f"after {timeout_s:.0f}s"])
            time.sleep(0.1)

    def shutdown(self, timeout_s: float = 60.0):
        """Drain-then-exit every replica (zero dropped waiters), join
        the supervisor, return its
        :class:`~tensordiffeq_tpu_torch.resilience.ClusterResult`.

        The ``/shutdown`` POSTs repeat until the supervisor joins: a
        slot that is mid-respawn when shutdown starts is not listening
        YET (the POST fails silently), and a single-shot goodbye would
        leave it serving forever while the join times out."""
        from concurrent.futures import TimeoutError as FuturesTimeout
        deadline = time.monotonic() + float(timeout_s)
        result = None
        while True:
            for url in self.endpoints().values():
                try:
                    _http_json("POST", url, "/shutdown", payload={},
                               timeout=5.0)
                except (OSError, http.client.HTTPException):
                    pass  # dead or not up yet — retried next lap
            if self._future is None:
                break
            try:
                result = self._future.result(timeout=min(
                    2.0, max(0.1, deadline - time.monotonic())))
                break
            except FuturesTimeout:
                if time.monotonic() > deadline:
                    raise
        if self._pool is not None:
            self._pool.shutdown(wait=False)
        self._pool = self._future = None
        return result

    def serve_metrics(self, addr: str = "127.0.0.1", port: int = 0, *,
                      slos=None, host: Optional[str] = None):
        """One fleet-wide scrape target: a
        :class:`~tensordiffeq_tpu_torch.telemetry.Collector` merging the
        supervisor's registry with every replica run dir (their beat
        threads publish live ``metrics.live.json`` snapshots, so replica
        counters show up while the replicas run).  Attach the front
        router's registry too (``collector.attach_registry``) to fold in
        availability/failover instruments."""
        from ..telemetry.collector import Collector
        label = host if host is not None else socket.gethostname()
        c = Collector(slos=slos)
        c.attach_registry(self.supervisor.registry, host=label,
                          process=f"supervisor:{os.getpid()}")
        for d in self.run_dirs():
            c.watch(d, host=label)
        c.serve(addr, port)
        self.collector = c
        return c


# -------------------------------------------------------------------------- #
# the front tier: rendezvous hashing + breaker/retry failover
# -------------------------------------------------------------------------- #
def _rendezvous_weight(tenant: str, name: str) -> int:
    h = hashlib.blake2b(f"{tenant}|{name}".encode("utf-8"), digest_size=8)
    return int.from_bytes(h.digest(), "big")


class FrontRouter:
    """Hash tenants onto replicas; own the request-level robustness
    ladder (see module docstring).

    Args:
      replicas: ``{name: base_url}`` (a :meth:`ReplicaGroup.endpoints`).
      retry: failover pacing BETWEEN candidate sweeps — ``max_attempts``
        bounds the sweeps, ``delay_s`` the inter-sweep backoff.
      breaker_failure_threshold / breaker_reset_timeout_s: the
        per-replica breaker.  The default threshold of 1 is deliberate:
        one TRANSPORT failure (connection refused/reset/dropped) opens
        the breaker, because unlike a tenant op there is no partial
        failure mode — and the half-open probe re-admits the replica the
        moment it answers again.
      deadline_s: default end-to-end budget per query (sweeps + backoff).
      call_timeout_s: per-HTTP-call socket timeout.
      hedge_after_s: opt-in tail tolerance — when the primary attempt
        has not resolved after this long, a second attempt starts on the
        rotated candidate list and the first success wins.
      quorum: live replicas required for nominal admission (default:
        majority).  Below it, ``admission.degrade(degrade_factor)``
        tightens the watermarks; back at quorum, ``restore()``.
      admission: the :class:`AdmissionController` to degrade (optional —
        without one, quorum loss is only surfaced via signals).
    """

    def __init__(self, replicas: dict, *,
                 retry: Optional[RetryPolicy] = None,
                 breaker_failure_threshold: int = 1,
                 breaker_reset_timeout_s: float = 1.0,
                 deadline_s: float = 10.0, call_timeout_s: float = 10.0,
                 hedge_after_s: Optional[float] = None,
                 quorum: Optional[int] = None,
                 admission: Optional[AdmissionController] = None,
                 degrade_factor: float = 0.5, registry=None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        if not replicas:
            raise ValueError("FrontRouter needs at least one replica")
        self.replicas = {str(k): str(v) for k, v in replicas.items()}
        self.retry = retry if retry is not None else RetryPolicy(
            max_attempts=3, base_delay_s=0.02, max_delay_s=0.2)
        self.deadline_s = float(deadline_s)
        self.call_timeout_s = float(call_timeout_s)
        self.hedge_after_s = (None if hedge_after_s is None
                              else float(hedge_after_s))
        self.quorum = (len(self.replicas) // 2 + 1 if quorum is None
                       else int(quorum))
        self.admission = admission
        self.degrade_factor = float(degrade_factor)
        self._registry = (registry if registry is not None
                          else default_registry())
        self._clock = clock
        self._sleep = sleep
        self._breakers = {
            name: CircuitBreaker(
                failure_threshold=breaker_failure_threshold,
                reset_timeout_s=breaker_reset_timeout_s,
                name=f"replica.{name}", clock=clock,
                registry=self._registry)
            for name in self.replicas}
        self._degraded = False
        self._hedge_pool = None
        self._update_availability()

    # ------------------------------------------------------------------ #
    def candidates(self, tenant: str) -> list:
        """Rendezvous order: every replica weighted by
        ``blake2b(tenant|name)``, highest first.  Removing one replica
        only re-homes the tenants whose TOP weight it held (~1/N of
        them); every other tenant's order is untouched — the remap bound
        consistent hashing promises, with no ring state to maintain."""
        return sorted(self.replicas,
                      key=lambda name: _rendezvous_weight(tenant, name),
                      reverse=True)

    def availability(self) -> float:
        """Fraction of replicas whose breaker is not open."""
        n = len(self._breakers)
        up = sum(1 for b in self._breakers.values() if b.state != "open")
        return up / n if n else 0.0

    def _update_availability(self) -> None:
        avail = self.availability()
        self._registry.gauge("fleet.replica.availability").set(avail)
        if self.admission is None:
            return
        up = round(avail * len(self._breakers))
        if up < self.quorum and not self._degraded:
            self._degraded = True
            self.admission.degrade(self.degrade_factor)
        elif up >= self.quorum and self._degraded:
            self._degraded = False
            self.admission.restore()

    # ------------------------------------------------------------------ #
    def _call(self, name: str, payload: dict, timeout: float):
        """One HTTP attempt against one replica; maps the wire protocol
        back onto the package's native exceptions.  Only TRANSPORT
        failures (and an explicit drain) become :class:`_ReplicaCallError`
        — a tenant-scoped error relayed by a healthy replica must never
        look like a dead replica."""
        try:
            status, body = _http_json("POST", self.replicas[name],
                                      "/query", payload, timeout=timeout)
        except (OSError, http.client.HTTPException) as e:
            raise _ReplicaCallError(
                f"{type(e).__name__}: {e}") from e
        if status == 200 and body.get("ok"):
            return _decode_result(body["result"])
        err = body.get("error")
        if status == 503 and err == "draining":
            raise _ReplicaCallError("draining")
        if status == 503 and err == "CircuitOpenError":
            raise CircuitOpenError(body.get("breaker", "fleet"),
                                   float(body.get("retry_after_s") or 0.0))
        if status == 429:
            raise AdmissionRejected(
                body.get("tenant", payload.get("tenant", "?")),
                body.get("reason", "rejected"),
                float(body.get("retry_after_s") or 0.0))
        if status == 504:
            raise RequestTimeout(float(body.get("waited_s") or 0.0))
        if status == 404:
            raise KeyError(body.get("detail") or payload.get("tenant"))
        raise ReplicaRequestError(name, status,
                                  f"{err}: {body.get('detail', '')}")

    def _sweep(self, tenant: str, payload: dict, deadline_t: float,
               cands: Sequence[str], trail: list):
        """Deadline-bounded failover sweeps over the candidate list.
        Transport failures burn the replica's breaker and move on; a
        structured error from a replica that ANSWERED re-raises (and
        counts as breaker success — the replica is reachable)."""
        tr = active_tracer()
        sweep = 0
        while True:
            tried_any = False
            for name in cands:
                br = self._breakers[name]
                if self._clock() >= deadline_t:
                    break
                if not br.allow():
                    trail.append(f"{name}: breaker open")
                    if tr is not None:
                        tr.record_span("fleet.front.breaker_open",
                                       duration_s=0.0, status="error",
                                       replica=name, tenant=str(tenant))
                    continue
                tried_any = True
                timeout = min(self.call_timeout_s,
                              max(0.05, deadline_t - self._clock()))
                try:
                    out = self._call(name, payload, timeout)
                except _ReplicaCallError as e:
                    br.record_failure()
                    self._registry.counter("fleet.failover.attempts",
                                           replica=name).inc()
                    trail.append(f"{name}: {e}")
                    self._update_availability()
                    continue
                except Exception:
                    br.record_success()  # reachable; error is the answer
                    self._update_availability()
                    raise
                br.record_success()
                self._update_availability()
                if name != cands[0]:
                    self._registry.counter("fleet.failover.reroutes").inc()
                    if tr is not None:
                        tr.record_span("fleet.front.reroute",
                                       duration_s=0.0, replica=name,
                                       tenant=str(tenant))
                return out
            sweep += 1
            if self._clock() >= deadline_t \
                    or sweep >= self.retry.max_attempts or not tried_any:
                self._registry.counter("fleet.failover.unavailable").inc()
                raise ReplicaUnavailable(tenant, trail)
            self._sleep(min(self.retry.delay_s(sweep),
                            max(0.0, deadline_t - self._clock())))

    # ------------------------------------------------------------------ #
    def query(self, tenant: str, X, kind: str = "u", *,
              deadline_s: Optional[float] = None,
              priority: Optional[int] = None):
        """Route one query: encode once, sweep the tenant's rendezvous
        candidates under the deadline, return the decoded rows (bit-
        identical to a direct router with no chaos active).  With a
        tracer active the whole thing is one ``fleet.front.request``
        span — breaker-open and reroute events land inside it, so a
        failover incident reads as one timeline in the stitched
        trace."""
        tr = active_tracer()
        if tr is None:
            return self._query(tenant, X, kind, deadline_s, priority)
        with tr.span("fleet.front.request", tenant=str(tenant),
                     kind=str(kind)):
            return self._query(tenant, X, kind, deadline_s, priority)

    def _query(self, tenant, X, kind, deadline_s, priority):
        payload = {"tenant": str(tenant), "kind": str(kind),
                   "x": encode_array(np.atleast_2d(
                       np.asarray(X, np.float32)))}
        if priority is not None:
            payload["priority"] = int(priority)
        budget = self.deadline_s if deadline_s is None else float(deadline_s)
        deadline_t = self._clock() + budget
        t0 = self._clock()
        self._registry.counter("fleet.front.requests").inc()
        trail: list = []
        cands = self.candidates(tenant)
        if self.hedge_after_s is None:
            out = self._sweep(tenant, payload, deadline_t, cands, trail)
        else:
            out = self._hedged(tenant, payload, deadline_t, cands, trail)
        self._registry.histogram("fleet.front.latency_s").observe(
            self._clock() - t0)
        return out

    def _hedged(self, tenant, payload, deadline_t, cands, trail):
        """Tail-tolerant variant: when the primary sweep has not
        resolved after ``hedge_after_s``, a second sweep starts on the
        rotated candidate list and the first success wins (the loser is
        abandoned, not joined — a stuck socket must not hold the
        caller)."""
        from concurrent.futures import (FIRST_COMPLETED, ThreadPoolExecutor,
                                        wait)
        if self._hedge_pool is None:
            self._hedge_pool = ThreadPoolExecutor(
                max_workers=4, thread_name_prefix="tdq-front-hedge")
        primary = self._hedge_pool.submit(
            self._sweep, tenant, payload, deadline_t, list(cands), trail)
        done, _ = wait({primary}, timeout=self.hedge_after_s,
                       return_when=FIRST_COMPLETED)
        if done:
            return primary.result()
        self._registry.counter("fleet.failover.hedges").inc()
        hedge_trail: list = []
        secondary = self._hedge_pool.submit(
            self._sweep, tenant, payload, deadline_t,
            list(cands[1:]) + list(cands[:1]), hedge_trail)
        futs = {primary, secondary}
        last_exc: Optional[BaseException] = None
        while futs:
            done, futs = wait(futs, return_when=FIRST_COMPLETED)
            for f in done:
                try:
                    return f.result()
                except Exception as e:
                    last_exc = e
        trail.extend(hedge_trail)
        raise last_exc if last_exc is not None \
            else ReplicaUnavailable(tenant, trail)

    # ------------------------------------------------------------------ #
    def drain(self, name: str) -> int:
        """Planned-restart drain of one replica: its in-flight waiters
        complete, then it rejects queries (failover re-homes its
        tenants) until the supervisor recycles it."""
        status, body = _http_json("POST", self.replicas[name], "/drain",
                                  payload={}, timeout=self.call_timeout_s)
        if status != 200:
            raise ReplicaRequestError(name, status,
                                      str(body.get("error")))
        return int(body.get("drained_points") or 0)

    def stats(self) -> dict:
        return {
            "replicas": {name: {"url": url,
                                "breaker": self._breakers[name].state}
                         for name, url in self.replicas.items()},
            "availability": self.availability(),
            "quorum": self.quorum,
            "degraded": self._degraded,
        }

    def autoscale_signals(self) -> dict:
        """The front tier's scale inputs: availability (the
        ``replica_availability`` SLO's gauge), quorum state, and
        per-replica breaker states — a persistently open breaker with
        availability below quorum is the 'add a replica' signal."""
        avail = self.availability()
        up = round(avail * len(self._breakers))
        return {
            "replicas": {name: b.state
                         for name, b in self._breakers.items()},
            "availability": avail,
            "quorum": self.quorum,
            "below_quorum": up < self.quorum,
            "degraded": self._degraded,
        }

    def close(self) -> None:
        if self._hedge_pool is not None:
            self._hedge_pool.shutdown(wait=False)
            self._hedge_pool = None


if __name__ == "__main__":
    main()
