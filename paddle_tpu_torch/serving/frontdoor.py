"""The serving front door (counterpart of
paddle_tpu/serving/frontdoor.py): a threaded TCP server speaking
`wire.py`'s newline-delimited JSON protocol over a `ServingFleet` —
the reference's pserver RPC / go-master service surface recast for
inference serving.

Design rules, in fleet order of precedence:

- **Auth -> tenant**: a connection's `hello` token maps to a tenant
  name (the `auth` table); every `generate` on that connection is
  admitted through the quota/WFQ machinery as that tenant. A
  multi-tenant fleet refuses unauthenticated generates
  (UNAUTHORIZED) — quotas with an anonymous bypass are decoration.
- **Typed rejections only**: every fleet verdict crosses the wire as
  a stable `ERROR_CODES` code via `wire.error_code_for`; a stack
  trace never does.
- **Streaming rides the journal**: a `"stream": true` generate pumps
  `FleetHandle.stream_chunks()` — chunks are the journal's
  batched-flush progress records, so what the client sees is exactly
  what failover would resume from, and the concatenation is
  bit-identical to `done.tokens` across kill drills.
- **Disconnect == cancel**: a dropped connection cancels every
  request it owns (`ServingFleet.cancel`), journaling a `cancelled`
  terminal and freeing the abandoned stream's KV blocks at the
  holder's next handshake.
- **Drain, never drop**: `drain()` stops accepting, refuses new
  generates with SERVER_DRAINING, and waits for in-flight requests
  to reach their fleet verdicts — the wire-side half of the fleet's
  own drain discipline.

Threads: one acceptor, one reader per connection, one pump per
in-flight request. Pumps and the reader share the connection's write
lock; connection state is guarded by the connection's own lock —
never the fleet's."""

import socket
import threading
import time
from typing import Dict, Optional

from . import wire
from .fleet import ServingFleet, _SLO_UNSET

# generate-frame keys forwarded to ServingFleet.submit verbatim (when
# present) — anything else in the frame is refused as BAD_REQUEST, so
# a typo'd knob fails loudly instead of silently serving defaults
_GENERATE_KEYS = ("op", "id", "prompt", "max_new_tokens",
                  "temperature", "eos_id", "seed", "publish_len",
                  "deadline_s", "stream", "slo", "adapter")


class _Conn(object):
    """One accepted connection: socket + its reader thread's state.
    `handles` maps the client's request id -> live FleetHandle;
    mutations happen under `lock` (a leaf lock — never held while
    calling into the fleet)."""

    def __init__(self, cid: str, sock: socket.socket):
        self.id = cid
        self.sock = sock
        self.rfile = sock.makefile("rb")
        self.wlock = threading.Lock()   # serializes frame writes
        self.lock = threading.Lock()
        self.handles: Dict[str, object] = {}  # guarded-by: lock
        self.tenant: Optional[str] = None     # guarded-by: lock
        self.closed = False                   # guarded-by: lock

    def send(self, frame: dict) -> bool:
        """Best-effort frame write: a dead client is handled by the
        reader's EOF (which cancels its requests) — pumps must not
        crash on it."""
        try:
            wire.send_frame(self.sock, frame, lock=self.wlock)
            return True
        except (OSError, ValueError, wire.WireError):
            return False

    def close_socket(self):
        with self.lock:
            if self.closed:
                return
            self.closed = True
        # shutdown FIRST: the reader thread parked in readline() holds
        # the BufferedReader lock rfile.close() needs — shutdown EOFs
        # the read and releases it (the close-vs-read deadlock when
        # close()/_abandon runs from another thread)
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        for closer in (self.sock.close, self.rfile.close):
            try:
                closer()
            except (OSError, ValueError):
                pass


class FrontDoor(object):
    """TCP front door over one `ServingFleet`. `auth` maps auth token
    -> tenant name (required for a multi-tenant fleet; optional
    labelling for a single-tenant one). `port=0` picks a free port —
    read `.address` after `start()`."""

    def __init__(self, fleet: ServingFleet, host: str = "127.0.0.1",
                 port: int = 0, auth: Optional[Dict[str, str]] = None,
                 backlog: int = 64,
                 request_wait_s: Optional[float] = None):
        self.fleet = fleet
        self.host = host
        self.port = port
        self.auth = dict(auth) if auth else None
        self.backlog = backlog
        # server-side patience per request (None = wait for the fleet
        # verdict): bounds how long a pump blocks on a stream chunk /
        # result before answering a typed TIMEOUT
        self.request_wait_s = request_wait_s
        self._listener: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._conns: Dict[str, _Conn] = {}    # guarded-by: _lock
        self._next_conn = 0                   # guarded-by: _lock
        self._draining = False                # guarded-by: _lock
        self._closed = False                  # guarded-by: _lock
        # wire-level O(1) counters (the fleet's stats discipline)
        self.conns_accepted = 0               # guarded-by: _lock
        self.frames_bad = 0                   # guarded-by: _lock
        self.requests_in = 0                  # guarded-by: _lock
        self.streams_in = 0                   # guarded-by: _lock
        self.cancels_in = 0                   # guarded-by: _lock
        self.disconnect_cancels = 0           # guarded-by: _lock
        self.drain_refused = 0                # guarded-by: _lock
        self.errors_out: Dict[str, int] = {}  # guarded-by: _lock

    # -- lifecycle ----------------------------------------------------

    def start(self) -> "FrontDoor":
        ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        ls.bind((self.host, self.port))
        ls.listen(self.backlog)
        self._listener = ls
        self.port = ls.getsockname()[1]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="frontdoor-accept",
            daemon=True)
        self._accept_thread.start()
        return self

    @property
    def address(self):
        return (self.host, self.port)

    def drain(self, timeout: float = 30.0) -> bool:
        """Stop accepting, refuse new generates (SERVER_DRAINING),
        wait for every in-flight request's fleet verdict. Live
        connections stay open until their requests finish — the
        wire-side half of the fleet drain discipline. Returns False
        if requests were still open at the deadline."""
        with self._lock:
            self._draining = True
            ls, self._listener = self._listener, None
        if ls is not None:
            # shutdown FIRST: close() alone does not wake a thread
            # blocked in accept() on Linux — shutdown makes the
            # pending accept return immediately
            try:
                ls.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                ls.close()
            except OSError:
                pass
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                busy = any(c.handles for c in self._conns.values())
            if not busy:
                return True
            time.sleep(0.005)
        with self._lock:
            return not any(c.handles for c in self._conns.values())

    def close(self, timeout: float = 10.0):
        """Drain, then drop every connection. Never closes the fleet —
        the caller owns it (it may outlive this front door)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self.drain(timeout=timeout)
        with self._lock:
            conns = list(self._conns.values())
        for c in conns:
            self._abandon(c)
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=timeout)

    def stats(self) -> dict:
        with self._lock:
            return {
                "conns_accepted": self.conns_accepted,
                "conns_open": len(self._conns),
                "requests_in": self.requests_in,
                "streams_in": self.streams_in,
                "cancels_in": self.cancels_in,
                "disconnect_cancels": self.disconnect_cancels,
                "drain_refused": self.drain_refused,
                "frames_bad": self.frames_bad,
                "errors_out": dict(self.errors_out),
                "draining": self._draining,
            }

    def _count_error(self, code: str):
        with self._lock:
            self.errors_out[code] = self.errors_out.get(code, 0) + 1

    # -- accept / read ------------------------------------------------

    def _accept_loop(self):  # thread: frontdoor-accept
        while True:
            with self._lock:
                ls = self._listener
            if ls is None:
                return
            try:
                sock, _addr = ls.accept()
            except OSError:
                return  # listener closed: drain/close
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                cid = "c%d" % self._next_conn
                self._next_conn += 1
                conn = _Conn(cid, sock)
                self._conns[cid] = conn
                self.conns_accepted += 1
            threading.Thread(
                target=self._reader_loop, args=(conn,),
                name="frontdoor-%s" % cid, daemon=True).start()

    def _reader_loop(self, conn: _Conn):  # thread: conn reader
        try:
            while True:
                try:
                    frame = wire.read_frame(conn.rfile)
                except wire.WireError as exc:
                    # a corrupt NDJSON stream cannot be resynchronized:
                    # answer typed, then treat it as a disconnect
                    with self._lock:
                        self.frames_bad += 1
                    conn.send(wire.error_frame(exc))
                    self._count_error(exc.code)
                    return
                if frame is None:
                    return  # clean EOF
                if not frame:
                    continue  # blank line keep-alive
                self._dispatch(conn, frame)
        except OSError:
            return  # socket died mid-read: same as EOF
        except ValueError:
            # close_socket() from another thread won the race and
            # closed rfile under our readline: same as EOF
            return
        finally:
            self._abandon(conn)

    def _dispatch(self, conn: _Conn, frame: dict):  # thread: conn reader
        op = frame.get("op")
        if op == "ping":
            conn.send({"op": "pong"})
        elif op == "hello":
            self._handle_hello(conn, frame)
        elif op == "generate":
            self._handle_generate(conn, frame)
        elif op == "cancel":
            self._handle_cancel(conn, frame)
        else:
            exc = ValueError("unknown op %r" % (op,))
            conn.send(wire.error_frame(exc, frame.get("id")))
            self._count_error("BAD_REQUEST")

    # -- ops ----------------------------------------------------------

    def _handle_hello(self, conn: _Conn, frame: dict):
        token = frame.get("token")
        tenant = None
        if self.auth is not None:
            if token not in self.auth:
                conn.send({"op": "error", "id": None,
                           "code": "UNAUTHORIZED",
                           "message": "unknown auth token"})
                self._count_error("UNAUTHORIZED")
                return
            tenant = self.auth[token]
        with conn.lock:
            conn.tenant = tenant
        conn.send({"op": "welcome", "proto": wire.PROTO_VERSION,
                   "tenant": tenant})

    def _handle_generate(self, conn: _Conn, frame: dict):
        req_id = frame.get("id")
        if not isinstance(req_id, str) or not req_id:
            conn.send(wire.error_frame(
                ValueError("generate needs a string id"), req_id))
            self._count_error("BAD_REQUEST")
            return
        with self._lock:
            draining = self._draining
            if draining:
                self.drain_refused += 1
        if draining:
            # refuse OUTSIDE _lock: it is non-reentrant and
            # _count_error needs it (and a socket write never belongs
            # under the server-wide lock anyway)
            conn.send({"op": "error", "id": req_id,
                       "code": "SERVER_DRAINING",
                       "message": "front door is draining"})
            self._count_error("SERVER_DRAINING")
            return
        with conn.lock:
            tenant = conn.tenant
            duplicate = req_id in conn.handles
        if duplicate:
            conn.send(wire.error_frame(
                ValueError("request id %r already in flight on this "
                           "connection" % req_id), req_id))
            self._count_error("BAD_REQUEST")
            return
        # a multi-tenant fleet admits nothing without a quota bucket
        # to charge: unauthenticated generates are refused before the
        # fleet ever sees them
        if self.fleet._tenants is not None and tenant is None:
            conn.send({"op": "error", "id": req_id,
                       "code": "UNAUTHORIZED",
                       "message": "multi-tenant fleet: hello with an "
                                  "auth token first"})
            self._count_error("UNAUTHORIZED")
            return
        unknown = [k for k in frame if k not in _GENERATE_KEYS]
        if unknown:
            conn.send(wire.error_frame(
                ValueError("unknown generate key(s) %r" % unknown),
                req_id))
            self._count_error("BAD_REQUEST")
            return
        streamed = bool(frame.get("stream", False))
        kw = {}
        for k in ("temperature", "eos_id", "seed", "publish_len",
                  "deadline_s", "adapter"):
            if frame.get(k) is not None:
                kw[k] = frame[k]
        if "slo" in frame:
            kw["slo"] = frame["slo"]  # explicit null = wildcard
        else:
            kw["slo"] = _SLO_UNSET    # absent = tenant/fleet default
        try:
            h = self.fleet.submit(
                frame.get("prompt", []),
                frame.get("max_new_tokens", 0),
                tenant=tenant if self.fleet._tenants is not None
                else None,
                stream=streamed, conn=conn.id, **kw)
        except Exception as exc:  # typed verdicts, never tracebacks
            ef = wire.error_frame(exc, req_id)
            conn.send(ef)
            self._count_error(ef["code"])
            return
        with conn.lock:
            if conn.closed:
                # the client vanished between read and submit: claw
                # the request back immediately, exactly like a
                # mid-stream disconnect would
                self.fleet.cancel(h.rid)
                return
            conn.handles[req_id] = h
        with self._lock:
            self.requests_in += 1
            if streamed:
                self.streams_in += 1
        conn.send({"op": "accepted", "id": req_id, "rid": h.rid})
        threading.Thread(
            target=self._pump, args=(conn, req_id, h, streamed),
            name="frontdoor-%s-%s" % (conn.id, req_id),
            daemon=True).start()

    def _handle_cancel(self, conn: _Conn, frame: dict):
        req_id = frame.get("id")
        with conn.lock:
            h = conn.handles.get(req_id)
        with self._lock:
            self.cancels_in += 1
        if h is not None:
            # the pump answers with the typed CANCELLED error once the
            # fleet verdict lands (or with done, if completion won the
            # race — the client must handle both orders)
            self.fleet.cancel(h.rid)

    def _pump(self, conn: _Conn, req_id: str, h, streamed: bool):
        # thread: request pump — owns every response frame for req_id
        # after `accepted`; exits by sending exactly one done/error
        try:
            if streamed:
                index = 0
                for chunk in h.stream_chunks(
                        timeout=self.request_wait_s):
                    conn.send({"op": "tokens", "id": req_id,
                               "index": index,
                               "tokens": [int(t) for t in chunk]})
                    index += len(chunk)
                # the generator closed without raising: h is done
                conn.send({"op": "done", "id": req_id,
                           "tokens": [int(t) for t in h.tokens],
                           "n": len(h.tokens), "replica": h.replica})
            else:
                h.result(timeout=self.request_wait_s)
                conn.send({"op": "done", "id": req_id,
                           "tokens": [int(t) for t in h.tokens],
                           "n": len(h.tokens), "replica": h.replica})
        except Exception as exc:
            ef = wire.error_frame(exc, req_id)
            conn.send(ef)
            self._count_error(ef["code"])
        finally:
            with conn.lock:
                conn.handles.pop(req_id, None)

    # -- disconnect ---------------------------------------------------

    def _abandon(self, conn: _Conn):
        """Client gone (EOF, reset, or close()): cancel every request
        this connection owns — the fleet journals `cancelled`
        terminals and frees the abandoned streams' KV blocks — then
        drop the connection."""
        with conn.lock:
            handles = list(conn.handles.values())
            conn.handles.clear()
        for h in handles:
            if self.fleet.cancel(h.rid):
                with self._lock:
                    self.disconnect_cancels += 1
        conn.close_socket()
        with self._lock:
            self._conns.pop(conn.id, None)
