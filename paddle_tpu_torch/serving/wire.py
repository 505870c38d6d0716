"""Wire protocol for the serving front door (counterpart of
paddle_tpu/serving/wire.py, frame for frame: a client of either package
talks to a front door of the other): newline-delimited JSON over TCP
— the reference's pserver RPC / go-master service surface recast for
inference, with the dumbest framing that can possibly work so every
drill stays byte-inspectable (`nc` is a valid client).

Framing: one UTF-8 JSON object per ``\\n``-terminated line, at most
`MAX_FRAME_BYTES` per line. Client frames carry an ``op`` and — for
request-scoped ops — a caller-chosen ``id`` string echoed on every
response frame, so one connection multiplexes any number of
outstanding requests.

Client -> server ops::

    {"op": "hello", "token": "<auth token>"}
    {"op": "generate", "id": "r1", "prompt": [1, 2, 3],
     "max_new_tokens": 8,
     # optional: "temperature", "eos_id", "seed", "deadline_s",
     #           "stream": true, "slo", "adapter"
    }
    {"op": "cancel", "id": "r1"}
    {"op": "ping"}

Server -> client frames::

    {"op": "welcome", "proto": 1, "tenant": "alice" | null}
    {"op": "accepted", "id": "r1", "rid": 7}
    {"op": "tokens", "id": "r1", "index": 0, "tokens": [5, 9]}
    {"op": "done", "id": "r1", "tokens": [5, 9, 4], "n": 3,
     "replica": "r0" | null}
    {"op": "error", "id": "r1" | null, "code": "DEADLINE_EXCEEDED",
     "message": "...", "retry_after_s": 0.5}   # retry_after optional
    {"op": "pong"}

``tokens`` frames stream the journal's batched-flush progress chunks
(``index`` is the cumulative generated-token count before the chunk);
``done.tokens`` is ALWAYS the full generated sequence, so a streaming
client can verify bit-identity between the concatenated chunks and
the final answer — the invariant the fleet guarantees across
failover/migration. Errors are TYPED, stable codes from
`ERROR_CODES`; a stack trace never crosses the wire."""

import json
import socket
import threading
from typing import Optional

from .engine import EngineFailed
from .fleet import (DeadlineExceeded, FleetSaturated, FleetTimeout,
                    RequestCancelled)
from .tenancy import TenantQuotaExceeded

PROTO_VERSION = 1

# one line of NDJSON may not exceed this (a 4k-token prompt of 7-digit
# ids is ~32 KiB; 1 MiB leaves an order of magnitude of headroom while
# bounding what one rogue client can make the server buffer)
MAX_FRAME_BYTES = 1 << 20

# the stable wire-level rejection vocabulary: every fleet verdict an
# operator can see maps to exactly one of these — clients dispatch on
# the CODE, the message is human context only and carries no contract
ERROR_CODES = {
    "FLEET_SATURATED": "max_pending open requests: shed, retry later",
    "TENANT_QUOTA_EXCEEDED": "the tenant's token bucket is spent "
                             "(retry_after_s rides along)",
    "DEADLINE_EXCEEDED": "the request's deadline_s budget expired",
    "ENGINE_FAILED": "the fleet lost every replica (or was closed) "
                     "with the request pending",
    "CANCELLED": "the request was cancelled client-side "
                 "(cancel frame or dropped connection)",
    "BAD_REQUEST": "malformed frame or unservable request parameters",
    "UNAUTHORIZED": "missing or unknown auth token",
    "SERVER_DRAINING": "the front door is draining: no new requests",
    "TIMEOUT": "the server-side wait budget ran out with the "
               "request still open",
    "INTERNAL": "unexpected server-side failure (never a stack trace)",
}


class WireError(RuntimeError):
    """A typed wire-level rejection (either side). `code` is one of
    `ERROR_CODES`; `retry_after_s` rides quota sheds."""

    def __init__(self, code: str, message: str,
                 retry_after_s: Optional[float] = None):
        super().__init__("%s: %s" % (code, message))
        self.code = code
        self.message = message
        self.retry_after_s = retry_after_s


def error_code_for(exc: BaseException):
    """Map a fleet/tenancy exception to its (code, retry_after_s)
    wire rejection — the ONE place the mapping lives, so the server
    and any in-process test agree on the vocabulary. Unknown
    exceptions become INTERNAL: typed, message-only, never a
    traceback."""
    if isinstance(exc, WireError):  # already typed: pass through
        return exc.code, exc.retry_after_s
    if isinstance(exc, TenantQuotaExceeded):
        return "TENANT_QUOTA_EXCEEDED", getattr(exc, "retry_after_s",
                                                None)
    if isinstance(exc, FleetSaturated):
        return "FLEET_SATURATED", None
    if isinstance(exc, DeadlineExceeded):
        return "DEADLINE_EXCEEDED", None
    if isinstance(exc, RequestCancelled):
        return "CANCELLED", None
    if isinstance(exc, FleetTimeout):
        return "TIMEOUT", None
    if isinstance(exc, EngineFailed):
        return "ENGINE_FAILED", None
    if isinstance(exc, (ValueError, KeyError, TypeError)):
        return "BAD_REQUEST", None
    return "INTERNAL", None


def error_frame(exc: BaseException, req_id=None) -> dict:
    """The error frame for an exception: stable code + the first line
    of the message (stack traces never cross the wire)."""
    code, retry = error_code_for(exc)
    msg = str(exc).splitlines()[0] if str(exc) else type(exc).__name__
    frame = {"op": "error", "id": req_id, "code": code, "message": msg}
    if retry is not None:
        frame["retry_after_s"] = float(retry)
    return frame


def encode_frame(obj: dict) -> bytes:
    data = (json.dumps(obj, separators=(",", ":")) + "\n").encode()
    if len(data) > MAX_FRAME_BYTES:
        raise WireError("BAD_REQUEST",
                        "frame of %d bytes exceeds MAX_FRAME_BYTES "
                        "(%d)" % (len(data), MAX_FRAME_BYTES))
    return data


def send_frame(sock: socket.socket, obj: dict,
               lock: Optional[threading.Lock] = None):
    """Serialize + send one frame; `lock` serializes concurrent
    writers (a connection's reader thread and its per-request pump
    threads share one socket)."""
    data = encode_frame(obj)
    if lock is not None:
        with lock:
            sock.sendall(data)
    else:
        sock.sendall(data)


def read_frame(rfile) -> Optional[dict]:
    """Read one frame from a buffered file object (sock.makefile).
    Returns None on clean EOF; raises WireError on an oversized or
    malformed line (the server answers BAD_REQUEST and drops the
    connection — resynchronizing inside a corrupt NDJSON stream is
    guesswork)."""
    line = rfile.readline(MAX_FRAME_BYTES + 1)
    if not line:
        return None
    if len(line) > MAX_FRAME_BYTES:
        raise WireError("BAD_REQUEST", "frame exceeds %d bytes"
                        % MAX_FRAME_BYTES)
    line = line.strip()
    if not line:
        return {}
    try:
        obj = json.loads(line.decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        raise WireError("BAD_REQUEST", "unparseable frame")
    if not isinstance(obj, dict):
        raise WireError("BAD_REQUEST", "frame must be a JSON object")
    return obj


class WireClient(object):
    """Minimal blocking client for tests and the load generator: one
    socket, explicit frames. NOT thread-safe for concurrent `recv` —
    multiplexing callers (loadgen) run one reader thread per
    connection and use `send` only."""

    def __init__(self, address, token: Optional[str] = None,
                 timeout: Optional[float] = None):
        self.sock = socket.create_connection(address, timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._rf = self.sock.makefile("rb")
        self._wlock = threading.Lock()
        self.tenant = None
        if token is not None:
            self.send({"op": "hello", "token": token})
            w = self.recv()
            if w is None or w.get("op") == "error":
                raise WireError(
                    (w or {}).get("code", "INTERNAL"),
                    (w or {}).get("message", "connection closed"))
            self.tenant = w.get("tenant")

    def send(self, frame: dict):
        send_frame(self.sock, frame, lock=self._wlock)

    def recv(self) -> Optional[dict]:
        return read_frame(self._rf)

    def generate(self, req_id: str, prompt, max_new_tokens: int,
                 **kw) -> dict:
        """Send one generate frame (non-blocking beyond the send)."""
        frame = {"op": "generate", "id": req_id,
                 "prompt": [int(t) for t in prompt],
                 "max_new_tokens": int(max_new_tokens)}
        frame.update(kw)
        self.send(frame)
        return frame

    def generate_blocking(self, req_id: str, prompt,
                          max_new_tokens: int, **kw) -> dict:
        """Send one generate and read frames until ITS done/error
        (single-outstanding-request convenience). Returns {"tokens",
        "chunks", "rid", "replica"}; raises WireError on a typed
        rejection. The bit-identity check is the caller's: for a
        streamed request, sum(chunks, []) must equal tokens."""
        self.generate(req_id, prompt, max_new_tokens, **kw)
        chunks, rid = [], None
        while True:
            f = self.recv()
            if f is None:
                raise WireError("INTERNAL",
                                "connection closed mid-request")
            if f.get("id") != req_id:
                continue  # a stale frame from a prior cancel/timeout
            op = f.get("op")
            if op == "accepted":
                rid = f.get("rid")
            elif op == "tokens":
                chunks.append(list(f["tokens"]))
            elif op == "done":
                return {"tokens": list(f["tokens"]), "chunks": chunks,
                        "rid": rid, "replica": f.get("replica")}
            elif op == "error":
                raise WireError(f["code"], f.get("message", ""),
                                f.get("retry_after_s"))

    def cancel(self, req_id: str):
        self.send({"op": "cancel", "id": req_id})

    def close(self):
        # shutdown FIRST: a reader thread parked in readline() holds
        # the BufferedReader lock that _rf.close() needs — shutdown
        # EOFs the read and releases it (the close-vs-recv deadlock)
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        try:
            self._rf.close()
        except (OSError, ValueError):
            pass
