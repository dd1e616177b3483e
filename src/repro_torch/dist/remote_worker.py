"""Socket-worker entry point for the multi-host backend (DESIGN.md §16).

The socket transport keeps the §9/§10/§12 scheduler wholly in the parent
(exactly like the §11 process backend) and ships task *bodies* to worker
processes connected over TCP — same host or remote. This module is the
worker side: a plain loop over one duplex socket to its dispatcher thread
in the parent, plus the pieces both ends share (framing, handshake
constants) and two launchers:

* ``python -m repro_torch.dist.remote_worker --connect host:port [--workers N]``
  — join a listening :class:`~repro_torch.dist.socket_pool.SocketPool` from any
  machine that can import this package;
* :func:`spawn_workers` — fork-and-connect N local workers (what
  ``SocketPool`` uses for single-host runs and tests).

**Framing.** Every message is one length-prefixed frame: a 4-byte
big-endian payload length followed by a pickled payload
(:class:`FramedConn`). Frames on one socket are strictly ordered, which is
what lets the per-connection transfer cache
(:class:`~repro_torch.dist.shm_arena.TransferCache`) mark an array digest as
peer-resident the moment the frame carrying its bytes is queued.

**Handshake.** Authentication comes first, and it runs on *raw* frames —
no pickle touches bytes from an unauthenticated peer (unpickling
attacker data is arbitrary code execution). Both directions prove
knowledge of the shared ``authkey`` with an HMAC-SHA256
challenge/response, the same shape as ``multiprocessing.connection``::

    parent -> worker   CHALLENGE || 32 random bytes          (raw frame)
    worker -> parent   HMAC-SHA256(authkey, nonce)           (raw frame)
    parent -> worker   WELCOME  (or FAILURE: connection dropped)
    worker -> parent   CHALLENGE || 32 random bytes          (roles swap:
    parent -> worker   HMAC-SHA256(authkey, nonce)            the worker
    worker -> parent   WELCOME                                authenticates
                                                              the parent too)

Only then does the pickled hello/ack exchange run::

    worker -> parent   {"magic": MAGIC, "version": PROTOCOL_VERSION,
                        "caps": {pid, host, nonce?, cpu_count, python}}
    parent -> worker   {"ok": True, "version": ..., "threshold": ...,
                        "heartbeat_s": ...}          # or {"ok": False, ...}

A peer that fails the challenge (or sends anything else first) is
dropped before any ``pickle.loads``; a version mismatch between
*authenticated* ends is rejected before the connection ever reaches a
scheduler slot. ``caps["nonce"]`` echoes the per-spawn token
:func:`spawn_workers` hands each local child, which is how the pool
binds a connection to the right ``Process`` (pids can collide across
hosts; nonces cannot).

**Trust model.** The authkey is a bearer secret: anyone holding it can
run arbitrary code on both ends (that is what a task body *is*), so it
must travel out of band over a trusted channel — an env var on the
worker hosts, a mode-0600 file — never on a command line.
``SocketPool`` generates a random key per pool when bound to loopback
and refuses to bind a non-loopback interface without an explicit one.
The transport authenticates but does not encrypt: task bodies and
results cross in cleartext, so run fleets on trusted networks (or
tunnel the port).

**Job protocol** (one in-flight job per worker — the dispatcher thread
blocks on the reply, heartbeats interleave)::

    parent -> worker   ("job", job_id, fn_wire, args_wire)   run this body
    parent -> worker   ("bye",)                               shut down
    worker -> parent   ("res", job_id, True,  result_wire)    body returned
    worker -> parent   ("res", job_id, False, exception_bytes) body raised
    worker -> parent   ("hb",)                                 liveness pulse

``fn_wire``/``args_wire``/``result_wire`` are ``repro_torch.dist.wire`` payloads;
arrays at/above the threshold ride the content-hashed transfer cache
instead of being re-pickled into every frame.

A worker catches *everything* a body raises — including ``SystemExit`` /
``KeyboardInterrupt`` — and reports it as a task failure; only socket loss
(parent gone) or the shutdown sentinel ends the loop. A worker that dies
anyway (``os._exit``, OOM kill, a severed link) surfaces in the parent as
:class:`~repro_torch.dist.process_pool.WorkerDiedError` on the in-flight task,
never as a hang: the heartbeat thread keeps pulsing even while a body
runs, so a silent peer is indistinguishable from a dead one only until
the liveness window expires.
"""
from __future__ import annotations

import argparse
import hashlib
import hmac
import os
import pickle
import secrets
import select
import socket
import struct
import sys
import threading
from typing import Any, Optional

from .shm_arena import DEFAULT_THRESHOLD, TransferCache
from .wire import dumps_exception, dumps_value, loads_args, loads_fn

__all__ = [
    "MAGIC",
    "PROTOCOL_VERSION",
    "AUTHKEY_ENV",
    "AuthenticationError",
    "FramedConn",
    "answer_challenge",
    "deliver_challenge",
    "worker_caps",
    "run_worker",
    "spawn_workers",
]

MAGIC = "repro-dist"
PROTOCOL_VERSION = 2  # v2: mandatory mutual HMAC auth before any pickle
DEFAULT_HEARTBEAT_S = 0.25

#: env var the ``remote_worker`` CLI reads the authkey from (hex-encoded)
AUTHKEY_ENV = "REPRO_DIST_AUTHKEY"

_HDR = struct.Struct("!I")

# auth-handshake raw-frame markers (never pickled, bounded length)
_CHALLENGE = b"#REPRO#CHALLENGE#"
_WELCOME = b"#REPRO#WELCOME#"
_FAILURE = b"#REPRO#FAILURE#"
_AUTH_NONCE_LEN = 32
_AUTH_MAX_FRAME = 128  # challenge/digest/verdict all fit well under this


class AuthenticationError(ConnectionError):
    """The peer failed (or never attempted) the authkey challenge."""


class FramedConn:
    """Length-prefixed pickle frames over one TCP socket.

    ``send`` is thread-safe (the worker's heartbeat thread shares the
    socket with its job loop); ``recv`` is single-reader by contract —
    exactly one thread reads a connection at a time (the §16 dispatcher
    holds the slot's I/O lock, the idle monitor only reads when it can
    take that lock). A ``recv`` that times out mid-frame leaves the
    stream desynchronized, which is fine: a timeout is a liveness verdict
    and the connection is discarded, never reused.
    """

    def __init__(self, sock: socket.socket) -> None:
        try:
            # frames are small and latency-bound: defeat Nagle batching
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass  # non-TCP transport (AF_UNIX socketpair in tests)
        self._sock = sock
        self._send_lock = threading.Lock()

    def send(self, obj: Any) -> None:
        payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        self.send_bytes(payload)

    def send_bytes(self, payload: bytes) -> None:
        """One raw frame (no pickling) — what the auth handshake rides."""
        with self._send_lock:
            self._sock.sendall(_HDR.pack(len(payload)) + payload)

    def _read_exact(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise EOFError("peer closed the connection")
            buf += chunk
        return bytes(buf)

    def recv_bytes(
        self, timeout: Optional[float] = None, max_len: Optional[int] = None
    ) -> bytes:
        """Next frame's raw payload, without unpickling. ``max_len`` caps
        the advertised length (pre-auth frames must be tiny: an attacker
        header must not be able to command a huge allocation).

        A timeout only bounds *this* read: the socket is restored to
        blocking before returning, so a later ``send`` of a large frame
        is never clipped by a stale liveness window.
        """
        self._sock.settimeout(timeout)
        try:
            (length,) = _HDR.unpack(self._read_exact(_HDR.size))
            if max_len is not None and length > max_len:
                raise AuthenticationError(
                    f"pre-auth frame of {length} bytes exceeds the "
                    f"{max_len}-byte handshake cap"
                )
            return self._read_exact(length)
        finally:
            try:
                self._sock.settimeout(None)
            except OSError:  # pragma: no cover - racing close
                pass

    def recv(self, timeout: Optional[float] = None) -> Any:
        """Next frame's payload. Raises ``EOFError`` on orderly close,
        ``TimeoutError`` past ``timeout`` (the §16 liveness window) and
        ``OSError`` on a severed link. Only call on an *authenticated*
        connection — unpickling untrusted bytes executes them."""
        return pickle.loads(self.recv_bytes(timeout))

    def poll(self) -> bool:
        """True when a frame (or EOF) is ready to read without blocking."""
        r, _w, _x = select.select([self._sock], [], [], 0)
        return bool(r)

    def fileno(self) -> int:
        return self._sock.fileno()

    def kill(self) -> None:
        """Sever the link abruptly (both directions) — the chaos harness's
        and the §16 watchdog's connection-loss primitive."""
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.close()

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def _coerce_authkey(authkey: Any) -> bytes:
    if isinstance(authkey, str):
        authkey = authkey.encode("utf-8")
    if not isinstance(authkey, (bytes, bytearray)) or not authkey:
        raise ValueError("authkey must be a non-empty bytes (or str) secret")
    return bytes(authkey)


def deliver_challenge(
    conn: FramedConn, authkey: bytes, *, timeout: float = 5.0
) -> None:
    """Challenge the peer to prove it holds ``authkey`` (raw frames only —
    this runs *before* any pickling trust is extended). Raises
    :class:`AuthenticationError` on a wrong or missing digest."""
    authkey = _coerce_authkey(authkey)
    nonce = secrets.token_bytes(_AUTH_NONCE_LEN)
    conn.send_bytes(_CHALLENGE + nonce)
    response = conn.recv_bytes(timeout=timeout, max_len=_AUTH_MAX_FRAME)
    expected = hmac.new(authkey, nonce, hashlib.sha256).digest()
    if not hmac.compare_digest(response, expected):
        try:
            conn.send_bytes(_FAILURE)
        except OSError:
            pass
        raise AuthenticationError("peer failed the authkey challenge")
    conn.send_bytes(_WELCOME)


def answer_challenge(
    conn: FramedConn, authkey: bytes, *, timeout: float = 5.0
) -> None:
    """Answer the peer's authkey challenge (raw frames only). Raises
    :class:`AuthenticationError` if the peer never sends a well-formed
    challenge or rejects our digest."""
    authkey = _coerce_authkey(authkey)
    msg = conn.recv_bytes(timeout=timeout, max_len=_AUTH_MAX_FRAME)
    if not msg.startswith(_CHALLENGE) or len(msg) != len(_CHALLENGE) + _AUTH_NONCE_LEN:
        raise AuthenticationError("peer did not open with an authkey challenge")
    nonce = msg[len(_CHALLENGE):]
    conn.send_bytes(hmac.new(authkey, nonce, hashlib.sha256).digest())
    verdict = conn.recv_bytes(timeout=timeout, max_len=_AUTH_MAX_FRAME)
    if verdict != _WELCOME:
        raise AuthenticationError("authkey rejected by peer")


def worker_caps() -> dict:
    """This host's capability record, sent in the handshake hello."""
    return {
        "pid": os.getpid(),
        "host": socket.gethostname(),
        "cpu_count": os.cpu_count(),
        "python": tuple(sys.version_info[:3]),
    }


def run_worker(
    host: str,
    port: int,
    *,
    authkey: bytes,
    connect_timeout: float = 20.0,
    spawn_nonce: Optional[str] = None,
) -> int:
    """Connect to a listening ``SocketPool`` and serve jobs until the
    shutdown sentinel or connection loss. Returns a process exit code
    (0 = orderly shutdown, 1 = authentication or handshake rejected).

    ``authkey`` is the pool's shared secret (``SocketPool.authkey``);
    the mutual challenge runs before any pickled frame in either
    direction, so a rogue listener on the port cannot feed this process
    bytes to unpickle. ``spawn_nonce`` is echoed in the hello caps so
    the parent can bind this connection to the ``Process`` it spawned
    (:func:`spawn_workers` sets it; remote workers leave it unset).
    """
    authkey = _coerce_authkey(authkey)
    sock = socket.create_connection((host, port), timeout=connect_timeout)
    sock.settimeout(None)  # create_connection leaves its timeout armed
    conn = FramedConn(sock)
    try:
        # answer the parent's challenge, then challenge it back — only a
        # peer that proved it holds the key may send us anything pickled
        answer_challenge(conn, authkey, timeout=connect_timeout)
        deliver_challenge(conn, authkey, timeout=connect_timeout)
    except (AuthenticationError, EOFError, OSError, TimeoutError):
        conn.close()
        return 1
    caps = worker_caps()
    if spawn_nonce is not None:
        caps["nonce"] = spawn_nonce
    conn.send({"magic": MAGIC, "version": PROTOCOL_VERSION, "caps": caps})
    try:
        ack = conn.recv(timeout=connect_timeout)
    except (EOFError, OSError, TimeoutError):
        conn.close()
        return 1
    if not (isinstance(ack, dict) and ack.get("ok")):
        conn.close()
        return 1
    cache = TransferCache(ack.get("threshold", DEFAULT_THRESHOLD))
    heartbeat_s = ack.get("heartbeat_s", DEFAULT_HEARTBEAT_S)

    stop = threading.Event()

    def _pulse() -> None:
        # keeps pulsing while a body runs, so the parent can tell "slow
        # body" from "dead worker" — the §16 liveness signal
        while not stop.wait(heartbeat_s):
            try:
                conn.send(("hb",))
            except OSError:
                return

    threading.Thread(target=_pulse, name="repro-sock-hb", daemon=True).start()
    try:
        while True:
            try:
                msg = conn.recv(timeout=None)
            except (EOFError, OSError):  # parent died or closed the link
                return 0
            if msg is None or msg[0] == "bye":  # orderly shutdown
                return 0
            _kind, job_id, fn_wire, args_wire = msg
            try:
                fn = loads_fn(fn_wire, cache)
                args = loads_args(args_wire, cache)
                result = fn(*args)
                reply = ("res", job_id, True, dumps_value(result, cache))
            except BaseException as exc:  # noqa: BLE001 - body verdicts travel home
                reply = ("res", job_id, False, dumps_exception(exc))
            try:
                conn.send(reply)
            except OSError:  # parent went away mid-reply
                return 0
    finally:
        stop.set()
        cache.close()
        conn.close()


def spawn_workers(
    n: int,
    address: tuple,
    *,
    authkey: bytes,
    mp_context: Optional[str] = None,
    name: str = "repro-sockworker",
) -> list:
    """Fork-and-connect ``n`` local worker processes against ``address``
    (``(host, port)``) — the single-host convenience ``SocketPool`` uses.
    ``authkey`` is the pool's secret (``pool.authkey``); it crosses into
    the children in-memory (process args), never on a command line.

    ``fork`` (default where available) inherits imported modules, so
    lambdas defined anywhere resolve in the worker exactly as on the §11
    process backend; ``spawn`` requires importable bodies. Returns the
    started ``multiprocessing.Process`` objects, each carrying the
    ``spawn_nonce`` its worker echoes in the hello — the collision-proof
    token the pool binds connections to processes with (pids recycle
    and collide across hosts; nonces cannot).
    """
    import multiprocessing as mp
    import warnings

    authkey = _coerce_authkey(authkey)
    ctx_name = mp_context or ("fork" if "fork" in mp.get_all_start_methods() else "spawn")
    ctx = mp.get_context(ctx_name)
    host, port = address
    procs = []
    with warnings.catch_warnings():
        # same rationale as ProcessPool._start_worker: the worker loop
        # never touches jax post-fork
        warnings.filterwarnings("ignore", message=".*fork.*", category=RuntimeWarning)
        for i in range(n):
            nonce = secrets.token_hex(16)
            proc = ctx.Process(
                target=run_worker,
                args=(host, port),
                kwargs={"authkey": authkey, "spawn_nonce": nonce},
                name=f"{name}-{i}",
                daemon=True,
            )
            proc.spawn_nonce = nonce
            proc.start()
            procs.append(proc)
    return procs


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.dist.remote_worker",
        description="Join a listening repro_torch.dist.SocketPool as a worker host.",
    )
    ap.add_argument(
        "--connect",
        required=True,
        metavar="HOST:PORT",
        help="address the SocketPool parent is listening on",
    )
    ap.add_argument(
        "--workers",
        type=int,
        default=1,
        help="worker processes to run from this host (default 1)",
    )
    ap.add_argument(
        "--authkey-file",
        metavar="PATH",
        help="file holding the pool's raw authkey bytes (overrides "
        f"${AUTHKEY_ENV}); keys never belong on a command line",
    )
    args = ap.parse_args(argv)
    host, _, port_s = args.connect.rpartition(":")
    if not host or not port_s.isdigit():
        ap.error(f"--connect expects HOST:PORT, got {args.connect!r}")
    host, port = host.strip("[]"), int(port_s)
    if args.authkey_file:
        with open(args.authkey_file, "rb") as fh:
            authkey = fh.read().strip()
    else:
        key_hex = os.environ.get(AUTHKEY_ENV, "")
        try:
            authkey = bytes.fromhex(key_hex) if key_hex else b""
        except ValueError:
            ap.error(f"${AUTHKEY_ENV} must be the authkey hex-encoded "
                     "(pool.authkey.hex())")
    if not authkey:
        ap.error(
            "no authkey: export the pool's key via "
            f"{AUTHKEY_ENV}=<pool.authkey.hex()> or pass --authkey-file "
            "(the parent refuses unauthenticated workers)"
        )
    if args.workers == 1:
        return run_worker(host, port, authkey=authkey)
    procs = spawn_workers(args.workers, (host, port), authkey=authkey)
    code = 0
    for proc in procs:
        proc.join()
        code = max(code, proc.exitcode or 0)
        proc.close()
    return code


if __name__ == "__main__":
    sys.exit(main())
