"""Transports carrying the BuffetFS wire protocol.

Two interchangeable transports speak the same `repro_torch.core.wire` protocol:

* `TCPTransport` — real sockets (ThreadingTCPServer); proves the protocol is
  a genuine wire protocol, used by the failover demo and TCP tests.
* `InProcTransport` — in-process registry with an injectable `LatencyModel`;
  makes the paper's latency experiments (Figs. 3–4) deterministic and
  CI-runnable on one core.  Latency is injected with `time.sleep`, so thread
  concurrency behaves like network concurrency (sleeps overlap).

Both directions use the same `request()` call: clients register a callback
address so servers can push INVALIDATE messages (paper §3.4).
"""
from __future__ import annotations

import socket
import socketserver
import threading
import time
from dataclasses import dataclass
import itertools
import queue
from typing import Callable, Dict, List, Optional

from .wire import Message, MsgType, RpcStats, error

Handler = Callable[[Message], Message]
Addr = str  # opaque address token; for TCP it is "host:port"


@dataclass
class LatencyModel:
    """Injected network/service latency for the in-proc transport.

    Defaults are calibrated to the paper's testbed scale (IB-connected
    cluster, HDD-backed Lustre): ~200us round trip for a small RPC plus
    bandwidth-proportional transfer time and a fixed server service time.
    """

    rtt_us: float = 200.0
    per_mib_us: float = 180.0       # ~5.5 GiB/s effective link
    service_us: float = 20.0

    def delay_s(self, req_bytes: int, resp_bytes: int) -> float:
        xfer = (req_bytes + resp_bytes) / (1024 * 1024) * self.per_mib_us
        return (self.rtt_us + self.service_us + xfer) * 1e-6


ZERO_LATENCY = LatencyModel(rtt_us=0.0, per_mib_us=0.0, service_us=0.0)


class Transport:
    """Abstract request/response transport."""

    def request(self, addr: Addr, msg: Message, *, critical: bool = True,
                stats: Optional[RpcStats] = None) -> Message:
        raise NotImplementedError

    def request_many(self, addr: Addr, msgs: List[Message], *,
                     critical: bool = True, stats: Optional[RpcStats] = None
                     ) -> List[Message]:
        """Issue several independent requests to one server.  The base
        implementation is sequential; pipelining transports overlap them."""
        return [self.request(addr, m, critical=critical, stats=stats)
                for m in msgs]

    def serve(self, addr: Addr, handler: Handler) -> None:
        raise NotImplementedError

    def shutdown(self, addr: Addr) -> None:
        raise NotImplementedError

    def wrap_handler(self, addr: Addr,
                     wrap: Callable[[Handler], Handler]) -> Callable[[], None]:
        """Fault-injection hook: replace the handler serving `addr` with
        ``wrap(original)`` and return a zero-arg restore.  Implemented by
        every transport that can serve, so delay/partition injectors work
        identically over in-proc and TCP clusters.  Restoring after the
        address was shut down (or re-served) is a safe no-op."""
        raise NotImplementedError


class _WorkerPool:
    """Persistent bounded worker pool for `InProcTransport.request_many`.

    The previous implementation spawned a fresh thread per message per
    wave; thread create/start/join costs ~100us apiece on this container —
    the same order as the simulated RPC latencies — so fan-out benchmarks
    were measuring thread churn, not the protocol.  Workers here are
    daemon threads spawned on demand up to `size` and retire after
    `idle_s` without work, so an idle transport pins no threads and a
    process churning through many short-lived clusters doesn't accumulate
    them.

    Invariant: pool tasks must never themselves submit to the pool (a
    server handler reached from a pool worker doing its own fan-out would
    risk exhausting the workers it is waiting on).  Server-side chunk
    orchestration therefore uses plain sequential `request()` calls."""

    def __init__(self, size: int, idle_s: float = 10.0) -> None:
        self.size = max(1, size)
        self.idle_s = idle_s
        self._q: "queue.Queue[Callable[[], None]]" = queue.Queue()
        self._lock = threading.Lock()
        self._workers = 0
        self._idle = 0

    def submit(self, fn: Callable[[], None]) -> None:
        self._q.put(fn)
        with self._lock:
            # spawn while queued work outpaces the waiting workers (a
            # plain idle==0 check under-spawns during a burst: workers
            # that just grabbed a task read as "about to be idle" and a
            # 15-task fan-out ends up sharing too few threads)
            if self._workers < self.size and self._q.qsize() > self._idle:
                self._workers += 1
                threading.Thread(target=self._run, daemon=True).start()

    def _run(self) -> None:
        while True:
            with self._lock:
                self._idle += 1
            try:
                fn: Optional[Callable[[], None]] = self._q.get(
                    timeout=self.idle_s)
            except queue.Empty:
                fn = None
            with self._lock:
                self._idle -= 1
                if fn is None:
                    # re-check under the lock before retiring: a submit()
                    # that raced our timeout saw an idle worker and did not
                    # spawn, so its task must not be stranded
                    try:
                        fn = self._q.get_nowait()
                    except queue.Empty:
                        self._workers -= 1
                        return
            try:
                fn()
            except Exception:
                pass  # task wrappers capture their own failures


class InProcTransport(Transport):
    """Registry-based transport with injected latency.

    `simulate_contention=True` serializes request service *per server
    address* (a server node has finite service capacity) while the network
    RTT portion overlaps freely across threads — this is what exposes the
    MDS bottleneck in the Fig. 4 concurrency experiment.
    """

    def __init__(self, latency: Optional[LatencyModel] = None,
                 simulate_contention: bool = True) -> None:
        self.latency = latency or ZERO_LATENCY
        self.simulate_contention = simulate_contention
        self._handlers: Dict[Addr, Handler] = {}
        self._svc_locks: Dict[Addr, threading.Lock] = {}
        self._lock = threading.Lock()
        # sized well above one connection's TCP window (32): this pool is
        # shared by EVERY (client, server) pair on the transport, and a
        # worker holds its slot for the whole simulated RTT — sizing it at
        # one window would serialize independent clients' fan-outs against
        # each other, which the per-connection TCP windows never do
        self._pool = _WorkerPool(4 * MAX_INFLIGHT_PER_CONN)

    def serve(self, addr: Addr, handler: Handler) -> None:
        with self._lock:
            self._handlers[addr] = handler
            self._svc_locks[addr] = threading.Lock()

    def shutdown(self, addr: Addr) -> None:
        with self._lock:
            self._handlers.pop(addr, None)
            self._svc_locks.pop(addr, None)

    def wrap_handler(self, addr: Addr,
                     wrap: Callable[[Handler], Handler]) -> Callable[[], None]:
        with self._lock:
            orig = self._handlers.get(addr)
            if orig is None:
                raise KeyError(f"no handler serving {addr!r}")
            self._handlers[addr] = wrap(orig)

        def restore() -> None:
            with self._lock:
                if addr in self._handlers:  # not shut down meanwhile
                    self._handlers[addr] = orig
        return restore

    def request(self, addr: Addr, msg: Message, *, critical: bool = True,
                stats: Optional[RpcStats] = None) -> Message:
        with self._lock:
            handler = self._handlers.get(addr)
            svc_lock = self._svc_locks.get(addr)
        if handler is None:
            return error(107, f"server {addr!r} unreachable")  # ENOTCONN
        req_bytes = msg.nbytes
        lat = self.latency
        # batch physics: a BATCH envelope pays ONE round trip but the server
        # still performs (and is occupied for) every sub-operation, so the
        # service time scales with the sub-message count while the RTT does
        # not — this asymmetry is what makes batching win.
        n_sub = msg.header.get("n", 1) if msg.type is MsgType.BATCH else 1
        svc_s = lat.service_us * n_sub * 1e-6
        # service time: serialized per server when contention is simulated
        # (this is what exposes the MDS bottleneck under concurrency).  The
        # handler itself runs OUTSIDE the lock — like the TCP server's
        # worker pool, a server executes handlers concurrently and they
        # serialize on their own internal locks; only the modeled service
        # occupancy is exclusive.  This also makes server-to-server calls
        # from inside a handler (striped chunk orchestration) deadlock-free:
        # holding host A's service lock while requesting host B, and vice
        # versa, would otherwise cycle.  (The lock is only ever held
        # ACROSS a sleep, never across a nested request.)
        contended = (self.simulate_contention and svc_lock is not None)
        if lat.service_us:
            if contended:
                with svc_lock:
                    time.sleep(svc_s)
            else:
                time.sleep(svc_s)
        resp = handler(msg)
        resp_bytes = resp.nbytes
        # network: the byte-proportional transfer is a PER-SERVER resource
        # (the server's NIC/disk ships one stream at a time), so it
        # serializes under the same service lock — this is what a striped
        # fan-out spreads across hosts, and without it N concurrent
        # readers of one host's 32 MiB file would stream "in parallel"
        # through hardware the model claims is a single server.  The RTT
        # is propagation: it overlaps freely across threads.
        xfer_s = ((req_bytes + resp_bytes) / (1024 * 1024)
                  * lat.per_mib_us * 1e-6)
        if xfer_s:
            if contended:
                with svc_lock:
                    time.sleep(xfer_s)
            else:
                time.sleep(xfer_s)
        if lat.rtt_us:
            time.sleep(lat.rtt_us * 1e-6)
        if stats is not None:
            # shared-buffer fast path: Message objects cross by reference —
            # nothing is serialized (nbytes above is codec arithmetic, not a
            # frame build), so encode_ns/decode_ns stay 0 and benchmarks on
            # this transport measure protocol cost, not codec cost
            stats.record(msg.type, req_bytes, resp_bytes, critical,
                         subops=n_sub, addr=addr)
        return resp

    def request_many(self, addr: Addr, msgs: List[Message], *,
                     critical: bool = True, stats: Optional[RpcStats] = None
                     ) -> List[Message]:
        """Pipelined fan-out, mirroring the TCP transport's request-id
        pipelining: all frames are outstanding at once, so their network
        RTT sleeps overlap while the per-server service lock still
        serializes the service time — N pipelined requests cost ~1 RTT +
        N service times, exactly the asymmetry a real network shows.

        Requests ride the persistent worker pool (bounded transport-wide;
        excess messages queue and run as workers free up)."""
        if len(msgs) <= 1:
            return [self.request(addr, m, critical=critical, stats=stats)
                    for m in msgs]
        results: List[Optional[Message]] = [None] * len(msgs)
        done = threading.Event()
        remaining = [len(msgs)]
        rlock = threading.Lock()

        def one(i: int, m: Message) -> None:
            try:
                results[i] = self.request(addr, m, critical=critical,
                                          stats=stats)
            except Exception as e:  # a handler bug must not strand the wait
                results[i] = error(5, f"transport task failed: {e}")  # EIO
            finally:
                with rlock:
                    remaining[0] -= 1
                    if remaining[0] == 0:
                        done.set()

        for i, m in enumerate(msgs):
            self._pool.submit(lambda i=i, m=m: one(i, m))
        done.wait()
        return results  # type: ignore[return-value]


# ---------------------------------------------------------------------------
# TCP transport
# ---------------------------------------------------------------------------

def _recv_exact(sock: socket.socket, n: int) -> bytes:
    # preallocate + recv_into: the old `bytes +=` per chunk re-copied the
    # whole prefix on every recv, turning a multi-MiB striped frame into
    # O(n^2) memcpy on the receive hot path
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            raise ConnectionError("peer closed")
        got += k
    return bytes(buf)


def _recv_frame(sock: socket.socket) -> bytes:
    head = _recv_exact(sock, 4)
    total = int.from_bytes(head, "little")
    return head + _recv_exact(sock, total - 4)


def _send_parts(sock: socket.socket, parts: List) -> None:
    """Vectored send: ship [header, payload] with socket.sendmsg so a bulk
    payload is never concatenated into a fresh header+payload buffer.
    Handles partial sends by advancing memoryview windows — still no copy."""
    iov = [p if type(p) is memoryview else memoryview(p) for p in parts]
    while iov:
        sent = sock.sendmsg(iov)
        while iov and sent >= len(iov[0]):
            sent -= len(iov[0])
            iov.pop(0)
        if sent:
            iov[0] = iov[0][sent:]


MAX_INFLIGHT_PER_CONN = 32  # server-side concurrent frames per connection


class _TCPHandler(socketserver.BaseRequestHandler):
    """One connection, many (pipelined) frames.

    rid-bearing frames are fed to a lazily-grown per-connection worker pool
    (capped at MAX_INFLIGHT_PER_CONN): the read loop never blocks on a
    handler, so one slow mutation cannot head-of-line-block other threads
    sharing the connection, while the sequential-RPC case reuses a single
    long-lived worker instead of paying thread create/teardown per frame.
    The rid demux on the client side makes out-of-order responses safe."""

    def handle(self) -> None:
        send_lock = threading.Lock()
        work_q: "queue.Queue[Optional[tuple]]" = queue.Queue()
        busy = [0]
        busy_lock = threading.Lock()
        workers: List[threading.Thread] = []

        def worker() -> None:
            while True:
                item = work_q.get()
                if item is None:
                    return
                msg, rid = item
                try:
                    try:
                        resp = self.server.buffet_handler(msg)  # type: ignore[attr-defined]
                    except Exception as e:  # last resort: never let a
                        # handler exception kill a pool worker silently
                        resp = error(5, f"handler error: {e}")  # EIO
                    resp.header["_rid"] = rid
                    try:
                        with send_lock:
                            _send_parts(self.request, resp.encode_parts())
                    except OSError:
                        pass  # connection gone; peer's waiter fails on its own
                finally:
                    with busy_lock:
                        busy[0] -= 1

        try:
            while True:
                try:
                    frame = _recv_frame(self.request)
                except (ConnectionError, OSError):
                    return
                msg = Message.decode(frame)
                # pipelining: the request id is transport-level framing, not
                # protocol payload — strip it before dispatch, echo it back
                # so the client can match responses to outstanding requests
                rid = msg.header.pop("_rid", None)
                if rid is None:
                    # legacy non-pipelined peer: in-order request/response
                    # (send under the shared lock — pool workers may be
                    # writing responses on this same socket)
                    resp = self.server.buffet_handler(msg)  # type: ignore[attr-defined]
                    try:
                        with send_lock:
                            _send_parts(self.request, resp.encode_parts())
                    except OSError:
                        return
                    continue
                with busy_lock:
                    busy[0] += 1
                    saturated = busy[0] > len(workers)
                if saturated and len(workers) < MAX_INFLIGHT_PER_CONN:
                    t = threading.Thread(target=worker, daemon=True)
                    t.start()
                    workers.append(t)
                work_q.put((msg, rid))
        finally:
            for _ in workers:
                work_q.put(None)


class _TCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class _Waiter:
    """One outstanding pipelined request awaiting its response."""

    __slots__ = ("event", "resp")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.resp: Optional[Message] = None


class _PipelinedConn:
    """One shared socket per server with request-id demultiplexing.

    Any number of threads send frames (serialized per frame by `send_lock`)
    and a single reader thread matches responses to waiters by the `_rid`
    echoed in the response header — so multiple outstanding requests share
    one connection instead of one connection per (thread, server)."""

    def __init__(self, addr: Addr, on_dead: Callable[["_PipelinedConn"], None],
                 connect_timeout_s: float = 10.0) -> None:
        host, _, port = addr.partition(":")
        self.addr = addr
        self.sock = socket.create_connection((host, int(port)),
                                             timeout=connect_timeout_s)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.sock.settimeout(None)  # reader blocks; waiters carry timeouts
        self.send_lock = threading.Lock()
        self.lock = threading.Lock()
        self.pending: Dict[int, _Waiter] = {}
        self.dead: Optional[str] = None
        self._on_dead = on_dead
        threading.Thread(target=self._reader, daemon=True).start()

    def _reader(self) -> None:
        while True:
            try:
                frame = _recv_frame(self.sock)
                t0 = time.perf_counter_ns()
                resp = Message.decode(frame)
                resp._decode_ns = time.perf_counter_ns() - t0
            except (OSError, ConnectionError) as e:
                self._fail(str(e))
                return
            rid = resp.header.pop("_rid", None)
            with self.lock:
                waiter = self.pending.pop(rid, None)
            if waiter is not None:
                waiter.resp = resp
                waiter.event.set()

    def _fail(self, why: str) -> None:
        with self.lock:
            self.dead = why
            stranded = list(self.pending.values())
            self.pending.clear()
        for w in stranded:
            w.event.set()  # resp stays None => unreachable
        try:
            self.sock.close()
        except OSError:
            pass
        self._on_dead(self)

    def submit(self, rid: int, msg: Message) -> Optional[_Waiter]:
        """Register a waiter and send the frame; None if the conn died."""
        waiter = _Waiter()
        with self.lock:
            if self.dead is not None:
                return None
            self.pending[rid] = waiter
        msg.header["_rid"] = rid
        t0 = time.perf_counter_ns()
        parts = msg.encode_parts()  # scatter/gather: payload never copied
        msg._encode_ns = time.perf_counter_ns() - t0
        try:
            with self.send_lock:
                _send_parts(self.sock, parts)
        except OSError as e:
            self._fail(str(e))
            return None
        return waiter


class TCPTransport(Transport):
    """Real TCP transport; addresses are "host:port" strings.

    Request-id-based pipelining: all threads share one connection per server
    address and may have many requests in flight at once; the per-connection
    reader thread demultiplexes responses by id."""

    REQUEST_TIMEOUT_S = 15.0

    def __init__(self, *, request_timeout_s: Optional[float] = None,
                 connect_timeout_s: float = 10.0,
                 connect_retries: int = 1,
                 connect_backoff_s: float = 0.05) -> None:
        # per-instance timeout (class attr kept as the default so existing
        # subclass/monkeypatch call sites keep working); connect failures
        # are retried with exponential backoff — a server restarting on
        # the same port refuses connections for a moment, which must read
        # as "slow network", not "host gone"
        self.request_timeout_s = (self.REQUEST_TIMEOUT_S
                                  if request_timeout_s is None
                                  else request_timeout_s)
        self.connect_timeout_s = connect_timeout_s
        self.connect_retries = max(0, connect_retries)
        self.connect_backoff_s = connect_backoff_s
        self._servers: Dict[Addr, _TCPServer] = {}
        self._conns: Dict[Addr, _PipelinedConn] = {}
        self._rids = itertools.count(1)
        self._lock = threading.Lock()

    def serve(self, addr: Addr, handler: Handler) -> Addr:
        host, _, port = addr.partition(":")
        srv = _TCPServer((host, int(port)), _TCPHandler)
        srv.buffet_handler = handler  # type: ignore[attr-defined]
        real = f"{srv.server_address[0]}:{srv.server_address[1]}"
        with self._lock:
            self._servers[real] = srv
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        return real

    def wrap_handler(self, addr: Addr,
                     wrap: Callable[[Handler], Handler]) -> Callable[[], None]:
        with self._lock:
            srv = self._servers.get(addr)
        if srv is None:
            raise KeyError(f"no server bound at {addr!r}")
        orig = srv.buffet_handler  # type: ignore[attr-defined]
        srv.buffet_handler = wrap(orig)  # type: ignore[attr-defined]

        def restore() -> None:
            with self._lock:
                cur = self._servers.get(addr)
            if cur is srv:  # not shut down / re-served meanwhile
                srv.buffet_handler = orig  # type: ignore[attr-defined]
        return restore

    def shutdown(self, addr: Addr) -> None:
        with self._lock:
            srv = self._servers.pop(addr, None)
        if srv is not None:
            srv.shutdown()
            srv.server_close()

    def _forget(self, conn: _PipelinedConn) -> None:
        with self._lock:
            if self._conns.get(conn.addr) is conn:
                del self._conns[conn.addr]

    def _conn(self, addr: Addr) -> _PipelinedConn:
        with self._lock:
            conn = self._conns.get(addr)
            if conn is not None and conn.dead is None:
                return conn
        conn = _PipelinedConn(addr, self._forget, self.connect_timeout_s)
        loser = None
        with self._lock:
            cur = self._conns.get(addr)
            if cur is not None and cur.dead is None:
                loser, conn = conn, cur  # lost the race; use the winner
            else:
                self._conns[addr] = conn
        if loser is not None:
            # dispose OUTSIDE self._lock: _fail calls back into _forget,
            # which takes self._lock (non-reentrant — would deadlock)
            loser._fail("superseded")
        return conn

    def _connect(self, addr: Addr) -> Optional[_PipelinedConn]:
        """Connect with bounded retry: a refused connect can be a server
        mid-restart on the same port, worth a brief backoff before the
        caller concludes the host is gone."""
        delay = self.connect_backoff_s
        for attempt in range(self.connect_retries + 1):
            try:
                return self._conn(addr)
            except (OSError, ConnectionError):
                if attempt == self.connect_retries:
                    return None
                time.sleep(delay)
                delay *= 2
        return None

    def _submit(self, addr: Addr, msg: Message):
        """Returns (conn, rid, waiter), or None if the server is gone."""
        conn = self._connect(addr)
        if conn is None:
            return None
        rid = next(self._rids)
        waiter = conn.submit(rid, msg)
        if waiter is None:
            return None
        return conn, rid, waiter

    def _await(self, addr: Addr, msg: Message, handle, *,
               critical: bool, stats: Optional[RpcStats]) -> Message:
        if handle is None:
            return error(107, f"server {addr!r} unreachable")  # ENOTCONN
        conn, rid, waiter = handle
        # a BATCH is N server-side operations (each possibly blocking on
        # watcher acks): scale the deadline with the sub-op count so a big
        # legitimate batch is not reported failed while the server applies it
        n_sub = msg.header.get("n", 1) if msg.type is MsgType.BATCH else 1
        timeout_s = self.request_timeout_s + 0.05 * (n_sub - 1)
        if not waiter.event.wait(timeout_s):
            # abandon the waiter so a late response doesn't leak an entry;
            # the server is alive-but-slow, which is not "unreachable"
            with conn.lock:
                conn.pending.pop(rid, None)
            return error(110, f"request to {addr!r} timed out")  # ETIMEDOUT
        if waiter.resp is None:
            return error(107, f"server {addr!r} unreachable")
        resp = waiter.resp
        if stats is not None:
            stats.record(msg.type, msg.nbytes, resp.nbytes, critical,
                         subops=n_sub, addr=addr,
                         encode_ns=msg._encode_ns,
                         decode_ns=resp._decode_ns)
        return resp

    def request(self, addr: Addr, msg: Message, *, critical: bool = True,
                stats: Optional[RpcStats] = None) -> Message:
        return self._await(addr, msg, self._submit(addr, msg),
                           critical=critical, stats=stats)

    def request_many(self, addr: Addr, msgs: List[Message], *,
                     critical: bool = True, stats: Optional[RpcStats] = None
                     ) -> List[Message]:
        """Pipelined fan-out: send every frame before collecting any
        response, so N requests cost ~1 RTT + N service times."""
        waiters = [self._submit(addr, m) for m in msgs]
        return [self._await(addr, m, w, critical=critical, stats=stats)
                for m, w in zip(msgs, waiters)]
