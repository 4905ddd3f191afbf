"""Worker-to-driver control plane of a HorovodRunner gang.

Counterpart of ``sparkdl_tpu/horovod/control_plane.py``, with the frames
this port uses: AUTH, READY, LOG (a worker's streamed stdout and stderr
lines), USERLOG (``log_to_driver``), RESULT (rank 0's cloudpickled return
value, in parts when it is larger than one frame), EXC (a rank's
traceback), BYE, and the telemetry frames: TELEMETRY (a flush of the
rank's metric snapshot and timeline events) and HEARTBEAT (its liveness
beacon), worker to driver, which the server hands to its
:class:`~sparkdl_tpu_torch.observe.aggregate.GangTelemetry` and
:class:`~sparkdl_tpu_torch.observe.health.HangDetector`; DUMP_REQ, driver
to worker on the rank's guaranteed socket, which the worker's watchdog
thread answers with a STACK_DUMP of every thread, however wedged its
training thread is; and PROFILE_REQ, driver to worker on the same
socket, which the watchdog hands to the rank's capture service
(:mod:`sparkdl_tpu_torch.observe.capture`; without one, with telemetry
off, the frame is dropped), and which the service answers with
PROFILE_DONE once its window is written. The frame numbers and layout
are the JAX package's.

Two frames are the port's only, numbered above the JAX package's 1-15:
SERVE_REQ (16), driver to the first rank of a fleet's gang replica on
its guaranteed socket, the requests the fleet admits to the replica and
its stop, which the watchdog thread hands to the rank's serving loop;
and SERVE_OUT (17), that rank to the driver, the replica's engine
contract, streamed tokens and finished or refused requests
(:class:`~sparkdl_tpu_torch.models.fleet.GangReplica`). The JAX fleet's
tensor-parallel engine is one GSPMD process and sends no such frames.

Log volume never blocks training (reference ``runner_base.py:65-68``):
LOG frames go into a bounded drop-oldest ring (:class:`LogRing`, 4 MiB)
that a daemon thread drains over a connection of its own, so a driver
slow to read stalls that thread, never the training thread, and never
holds the lock of the guaranteed socket that USERLOG, READY, RESULT,
EXC and BYE take. The ring is flushed, within ``LOG_FLUSH_S``, before
RESULT, EXC and BYE, and BYE reports how many frames it dropped. The
JAX package's ring is native code (``native/ctrl_plane.cc``); this one
is a Python thread.

The data plane (gradients, parameters, collectives) never touches this
channel; it runs over the gang's process group.

Frame format: ``u32 length | u8 type | u32 rank | payload`` (big
endian), where length counts type, rank and payload. JSON payloads,
except RESULT's raw bytes.

The driver unpickles RESULT, so whoever can deliver frames can run code
on the driver. Every connection must therefore open with an AUTH frame,
an HMAC of its rank under the per-job secret, which the launcher hands
a worker as the first line of its standard input and a Spark task in
its closure, and which never crosses the wire of this channel; and a
frame's length is capped before anything is allocated. Threat model:
peers without the secret. Workers hold it and are trusted.
"""

import collections
import contextlib
import hashlib
import hmac
import json
import os
import secrets as _secrets
import socket
import struct
import sys
import threading
import time
import traceback

# Message types (the JAX package's numbers)
MSG_READY = 1
MSG_LOG = 2
MSG_USERLOG = 3
MSG_RESULT = 4
MSG_EXC = 5
MSG_BYE = 6
MSG_AUTH = 7
MSG_RESULT_PART = 8  # a part of a RESULT larger than one frame
MSG_RESULT_END = 9  # ends a RESULT sent in parts
MSG_TELEMETRY = 10  # a metric snapshot and timeline events
MSG_HEARTBEAT = 11  # a rank's liveness beacon
MSG_DUMP_REQ = 12  # driver to worker: send every thread's stack
MSG_STACK_DUMP = 13  # worker to driver: the faulthandler dump text
MSG_PROFILE_REQ = 14  # driver to worker: capture a perf-forensics window
MSG_PROFILE_DONE = 15  # worker to driver: the capture's report meta
# the port's own frames (a fleet's gang replica), above the JAX numbers
MSG_SERVE_REQ = 16  # driver to worker: requests admitted to the replica
MSG_SERVE_OUT = 17  # worker to driver: tokens, finished, refused

_HEADER = struct.Struct(">IBI")  # length (of type+rank+payload), type, rank

# frame names, as the fault injection's CP_DROP names them
_MSG_NAMES = {
    MSG_READY: "READY", MSG_LOG: "LOG", MSG_USERLOG: "USERLOG",
    MSG_RESULT: "RESULT", MSG_EXC: "EXC", MSG_BYE: "BYE",
    MSG_AUTH: "AUTH", MSG_RESULT_PART: "RESULT", MSG_RESULT_END: "RESULT",
    MSG_TELEMETRY: "TELEMETRY", MSG_HEARTBEAT: "HEARTBEAT",
    MSG_STACK_DUMP: "STACK_DUMP", MSG_PROFILE_REQ: "PROFILE_REQ",
    MSG_PROFILE_DONE: "PROFILE_DONE", MSG_SERVE_REQ: "SERVE_REQ",
    MSG_SERVE_OUT: "SERVE_OUT",
}

# the launcher's worker environment: where the driver listens, the secret
CONTROL_ADDR_ENV = "SPARKDL_TORCH_CONTROL_ADDR"
CONTROL_SECRET_ENV = "SPARKDL_TORCH_CONTROL_SECRET"

MAX_FRAME = 64 << 20  # bounds what one frame may make the driver allocate
RESULT_CHUNK = 32 << 20  # a RESULT above this goes in parts
MAX_RESULT_TOTAL = 4 << 30  # and the driver keeps at most this much of it
# A log line is cut to this many characters by its sender, BEFORE it is
# encoded: cutting the encoded frame would leave invalid JSON, and one
# runaway line must not poison the connection that READY, RESULT and BYE
# still need.
MAX_LOG_TEXT = 64 << 10
# what the driver keeps of a traceback (the tail, which names the raise)
MAX_TRACEBACK = 4 * MAX_LOG_TEXT
# the log ring's capacity (the JAX package's NativeLogSender default),
# the kernel send buffer of its connection (small, so that the ring and
# its drop count, not the kernel, absorb a stalled driver), and how long
# RESULT, EXC and BYE wait for the ring to drain first
LOG_RING_BYTES = 4 << 20
LOG_SOCKET_BUFFER = 256 << 10
LOG_FLUSH_S = 5.0
# a worker's connections to the driver: its frames and its log ring
CONNECTIONS_PER_WORKER = 2


def auth_token(secret, rank):
    """A rank's credential: HMAC-SHA256 over the rank, so the secret
    itself never crosses the wire."""
    return hmac.new(secret.encode("utf-8"),
                    b"sparkdl-tpu-auth-v1" + struct.pack(">I", rank),
                    hashlib.sha256).digest()


def auth_frame(secret, rank):
    """The frame a client sends first on connecting."""
    token = auth_token(secret, rank)
    return _HEADER.pack(len(token) + 5, MSG_AUTH, rank) + token


_AUTH_PAYLOAD_LEN = len(auth_token("", 0))


def routable_host_ip():
    """Best-effort routable IP of this host (the UDP-connect trick, which
    sends no packet: ``gethostbyname(gethostname())`` gives 127.0.1.1 on
    a stock Debian ``/etc/hosts``, which would point remote workers at
    their own loopback)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect(("10.255.255.255", 1))
        return s.getsockname()[0]
    except OSError:
        return socket.gethostbyname(socket.gethostname())
    finally:
        s.close()


def _recv_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


class ControlPlaneServer:
    """The driver's end: a TCP server on an ephemeral port that merges
    the workers' log lines (and their BYEs) into ``log_path``, prints
    them per ``verbosity``, and collects READY, EXC and rank 0's RESULT.

    ``bind_host="127.0.0.1"`` (the default) serves the workers of this
    host; a gang with ranks on other machines (a Spark barrier job,
    remote ranks of a hosts spec) binds ``"0.0.0.0"``, and ``address``
    then advertises this host's routable IP. The per-job secret
    authenticates every connection either way.

    ``verbosity="all"`` prints every worker line to the driver's stdout
    as ``[rank] line``; ``"log_callback_only"`` prints only the
    ``log_to_driver`` messages. Either way every line goes to the log
    file.
    """

    def __init__(self, num_workers, verbosity="log_callback_only",
                 log_path=None, bind_host="127.0.0.1", telemetry=None,
                 health=None):
        self.verbosity = verbosity
        # the telemetry sinks (a GangTelemetry, a HangDetector): without
        # them, TELEMETRY and HEARTBEAT frames are dropped
        self._telemetry = telemetry
        self._health = health
        # rank -> its guaranteed socket (the one READY and HEARTBEAT come
        # on, which the worker's watchdog reads): where DUMP_REQ goes
        self._conns = {}
        self._stack_dumps = {}  # rank -> [dump text, ...]
        self._profile_reports = {}  # rank -> [PROFILE_DONE meta, ...]
        # the observer of PROFILE_DONE frames (the forensics manager's),
        # called outside the lock as on_profile_done(rank, meta)
        self.on_profile_done = None
        # the observer of SERVE_OUT frames (a fleet's gang replica),
        # called on the rank's connection thread as on_serve(rank, msg)
        self.on_serve = None
        self._send_lock = threading.Lock()  # driver-to-rank frames whole
        self.secret = _secrets.token_hex(32)  # the workers get it
        self._log_file = open(log_path, "a", buffering=1) if log_path \
            else None
        self._lock = threading.Lock()
        # one handler thread a worker: each printed line whole, never cut
        # by another's (print() writes the text and the newline apart)
        self._print_lock = threading.Lock()
        self._ready = set()
        self._result = None
        self._result_parts = []
        self._result_parts_bytes = 0
        self._result_overflow = False
        self._exceptions = {}  # rank -> traceback text
        self._threads = []
        # a worker's two connections (frames, log ring) each end here;
        # wait_drained waits for both of every rank that said BYE
        self._ended = collections.Counter()  # rank -> connections ended
        self._bye = set()
        self._conn_ended = threading.Condition(self._lock)
        self._closed = False
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((bind_host, 0))
        self._srv.listen(max(num_workers, 8))
        advertise = routable_host_ip() if bind_host == "0.0.0.0" \
            else bind_host
        self.address = f"{advertise}:{self._srv.getsockname()[1]}"
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="hvd-control-accept",
            daemon=True)
        self._accept_thread.start()

    def _accept_loop(self):
        while not self._closed:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 name="hvd-control-conn", daemon=True)
            t.start()
            with self._lock:
                self._threads = [x for x in self._threads if x.is_alive()]
                self._threads.append(t)

    def _log(self, text):
        with self._lock:
            if self._log_file is not None:
                self._log_file.write(text + "\n")

    def _serve_conn(self, conn):
        auth_rank = None  # the rank the AUTH frame proved
        try:
            while True:
                head = _recv_exact(conn, _HEADER.size)
                if head is None:
                    return
                length, mtype, rank = _HEADER.unpack(head)
                if auth_rank is None and length - 5 != _AUTH_PAYLOAD_LEN:
                    # before AUTH the only frame taken is AUTH's size
                    self._log(f"[control-plane] pre-auth frame of length "
                              f"{length}; closing")
                    return
                if length < 5 or length - 5 > MAX_FRAME:
                    self._log(f"[control-plane] oversized frame ({length} "
                              f"bytes) from rank {rank}; closing")
                    return
                payload = _recv_exact(conn, length - 5)
                if payload is None:
                    return
                if auth_rank is None:
                    if mtype != MSG_AUTH or not hmac.compare_digest(
                            payload, auth_token(self.secret, rank)):
                        self._log(f"[control-plane] unauthenticated "
                                  f"connection (frame type {mtype}, rank "
                                  f"{rank}); closing")
                        return
                    auth_rank = rank
                    continue
                if rank != auth_rank:
                    self._log(f"[control-plane] rank-{auth_rank} connection"
                              f" sent a frame of rank {rank}; closing")
                    return
                if mtype in (MSG_READY, MSG_HEARTBEAT):
                    with self._lock:
                        self._conns[rank] = conn
                try:
                    self._handle(mtype, rank, payload)
                except (ValueError, UnicodeError, AttributeError, TypeError,
                        KeyError):
                    # a malformed frame must not close the connection
                    # that READY, RESULT and BYE still need
                    self._log(f"[control-plane] bad frame from rank "
                              f"{rank}:\n{traceback.format_exc()}")
        except OSError:
            pass
        finally:
            with self._lock:
                if self._conns.get(auth_rank) is conn:
                    del self._conns[auth_rank]
            conn.close()
            if auth_rank is not None:
                with self._conn_ended:
                    self._ended[auth_rank] += 1
                    self._conn_ended.notify_all()

    def _handle(self, mtype, rank, payload):
        if mtype == MSG_READY:
            with self._lock:
                self._ready.add(rank)
        elif mtype == MSG_LOG:
            msg = json.loads(payload.decode("utf-8", "replace"))
            line = msg.get("text", "")
            self._log(f"[rank {rank} {msg.get('stream', 'stdout')}] {line}")
            if self.verbosity == "all":
                self._print(f"[{rank}] {line}")
        elif mtype == MSG_USERLOG:
            text = json.loads(payload.decode("utf-8", "replace")).get(
                "text", "")
            # the log_to_driver contract: the driver prints it
            self._print(text)
            self._log(f"[rank {rank} log_to_driver] {text}")
        elif mtype in (MSG_RESULT, MSG_RESULT_PART, MSG_RESULT_END):
            self._handle_result(mtype, rank, payload)
        elif mtype == MSG_EXC:
            tb = json.loads(payload.decode("utf-8", "replace")).get(
                "traceback", "")
            with self._lock:
                self._exceptions[rank] = tb
            self._log(f"[rank {rank} EXCEPTION]\n{tb}")
        elif mtype == MSG_TELEMETRY:
            if self._telemetry is not None:
                # ingest() shape-checks and raises on a malformed flush,
                # which costs that frame only
                self._telemetry.ingest(
                    rank, json.loads(payload.decode("utf-8", "replace")))
        elif mtype == MSG_HEARTBEAT:
            if self._health is not None:
                self._health.observe_beat(
                    rank, json.loads(payload.decode("utf-8", "replace")))
        elif mtype == MSG_STACK_DUMP:
            msg = json.loads(payload.decode("utf-8", "replace"))
            dump = str(msg.get("dump", ""))
            with self._lock:
                self._stack_dumps.setdefault(rank, []).append(dump)
            self._log(f"[rank {rank} STACK DUMP "
                      f"({msg.get('reason', 'requested')})]\n{dump}")
            if self._telemetry is not None:
                self._telemetry.add_stack_dump(rank, dump,
                                               reason=msg.get("reason"))
            if self._health is not None:
                self._health.note_stack_dump(rank)
        elif mtype == MSG_PROFILE_DONE:
            msg = json.loads(payload.decode("utf-8", "replace"))
            if not isinstance(msg, dict):
                msg = {}
            with self._lock:
                self._profile_reports.setdefault(rank, []).append(msg)
            self._log(f"[rank {rank} PROFILE DONE "
                      f"({msg.get('reason', 'requested')}) "
                      f"{msg.get('report') or ''}]")
            cb = self.on_profile_done
            if cb is not None:
                cb(rank, msg)
        elif mtype == MSG_SERVE_OUT:
            cb = self.on_serve
            if cb is not None:
                cb(rank, json.loads(payload.decode("utf-8", "replace")))
        elif mtype == MSG_BYE:
            with self._lock:
                self._bye.add(rank)
            msg = json.loads(payload.decode("utf-8", "replace"))
            dropped = int(msg.get("log_dropped", 0))
            self._log(f"[rank {rank} BYE] exit code {msg.get('exit_code')}, "
                      f"{dropped} log lines dropped")
            if dropped:
                self._print(f"[{rank}] {dropped} stdout/stderr lines were "
                            "dropped: the driver read them too slowly "
                            "(the rank's own log file has them all)")

    def _print(self, line):
        with self._print_lock:
            print(line, flush=True)

    def _handle_result(self, mtype, rank, payload):
        if rank != 0:
            # the job's value is rank 0's alone
            self._log(f"[control-plane] ignoring RESULT from rank {rank}")
            return
        with self._lock:
            if mtype == MSG_RESULT:
                self._result = payload
            elif mtype == MSG_RESULT_PART:
                if self._result_overflow:
                    return
                self._result_parts.append(payload)
                self._result_parts_bytes += len(payload)
                if self._result_parts_bytes > MAX_RESULT_TOTAL:
                    self._result_overflow = True
                    self._result_parts = []
            else:
                if not self._result_overflow:
                    self._result = b"".join(self._result_parts)
                self._result_parts = []
        if self._result_overflow and mtype == MSG_RESULT_PART:
            self._log(f"[control-plane] RESULT above {MAX_RESULT_TOTAL} "
                      "bytes; discarded")

    def wait_drained(self, timeout=5.0):
        """Join the connection handlers, so every frame already sent is
        handled (an exited worker's socket ends after its last byte).
        A rank that said BYE had opened its log ring's connection too,
        which the accept thread may not have taken up yet: wait for both
        of its connections to end. True when everything drained within
        ``timeout``, False when it ran out first."""
        deadline = time.monotonic() + timeout
        with self._lock:
            threads = list(self._threads)
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
        with self._conn_ended:
            ended = self._conn_ended.wait_for(
                lambda: all(self._ended[r] >= CONNECTIONS_PER_WORKER
                            for r in self._bye),
                max(0.0, deadline - time.monotonic()))
        return bool(ended) and not any(t.is_alive() for t in threads)

    def request_dump(self, rank, reason="stall"):
        """Ask ``rank`` for a stack dump of every thread, down its
        guaranteed socket; False when the rank has none (never sent READY
        or a beat) or the send fails. Never raises."""
        return self._send_frame(rank, MSG_DUMP_REQ, {"reason": reason})

    def request_profile(self, rank, reason="alert", rule=None, steps=None):
        """Ask ``rank`` to capture a perf-forensics window (a
        ``torch.profiler`` trace, the window's uncapped attribution, a
        memory snapshot) into its job dir, down its guaranteed socket;
        False when the rank has none or the send fails. Never raises."""
        req = {"reason": reason}
        if rule is not None:
            req["rule"] = rule
        if steps is not None:
            req["steps"] = int(steps)
        return self._send_frame(rank, MSG_PROFILE_REQ, req)

    def send_serve(self, rank, obj):
        """Send ``obj`` (JSON) to ``rank`` as SERVE_REQ, down its
        guaranteed socket; False when the rank has none or the send
        fails. Never raises."""
        return self._send_frame(rank, MSG_SERVE_REQ, obj)

    def _send_frame(self, rank, mtype, obj):
        """Send ``obj`` (JSON) to ``rank`` as one ``mtype`` frame down its
        guaranteed socket, whole: the hang detector's DUMP_REQ, the
        forensics' PROFILE_REQ and a fleet's SERVE_REQ come from
        different threads. False when the rank has none or the send
        fails. Never raises."""
        with self._lock:
            conn = self._conns.get(rank)
        if conn is None:
            return False
        payload = json.dumps(obj).encode("utf-8")
        try:
            with self._send_lock:
                conn.sendall(_HEADER.pack(len(payload) + 5, mtype, rank)
                             + payload)
        except OSError:
            return False
        return True

    def profile_reports(self, rank=None):
        """The PROFILE_DONE metas received: ``{rank: [meta, ...]}``, or
        one rank's list."""
        with self._lock:
            if rank is not None:
                return list(self._profile_reports.get(rank, ()))
            return {r: list(d) for r, d in self._profile_reports.items()}

    def stack_dumps(self, rank=None):
        """The stack dumps received: ``{rank: [text, ...]}``, or one
        rank's list."""
        with self._lock:
            if rank is not None:
                return list(self._stack_dumps.get(rank, ()))
            return {r: list(d) for r, d in self._stack_dumps.items()}

    def ready_count(self):
        with self._lock:
            return len(self._ready)

    @property
    def exceptions(self):
        with self._lock:
            return dict(self._exceptions)

    @property
    def result_bytes(self):
        with self._lock:
            return self._result

    def close(self):
        self._closed = True
        try:
            self._srv.close()
        except OSError:
            pass
        with self._lock:
            if self._log_file is not None:
                self._log_file.close()
                self._log_file = None


class LogRing:
    """A bounded drop-oldest queue of LOG frames and the daemon thread
    that drains it, in order, over its own authenticated connection.
    :meth:`send` never blocks on the network: when the queued bytes pass
    ``capacity`` the oldest frames are dropped and counted
    (:attr:`dropped`)."""

    def __init__(self, host, port, auth, capacity=LOG_RING_BYTES):
        self.capacity = capacity
        self.dropped = 0
        self._frames = collections.deque()
        self._bytes = 0
        self._sending = False  # a frame is off the queue, not yet sent
        self._closed = False
        self._dead = False  # the connection failed: everything drops
        self._cond = threading.Condition()
        self._sock = socket.create_connection((host, port), timeout=30)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF,
                              LOG_SOCKET_BUFFER)
        self._sock.settimeout(None)
        self._sock.sendall(auth)
        threading.Thread(target=self._drain, name="hvd-log-ring",
                         daemon=True).start()

    def send(self, frame):
        with self._cond:
            if self._closed or self._dead:
                self.dropped += 1
                return
            self._frames.append(frame)
            self._bytes += len(frame)
            while self._bytes > self.capacity and len(self._frames) > 1:
                self._bytes -= len(self._frames.popleft())
                self.dropped += 1
            self._cond.notify_all()

    def _drain(self):
        while True:
            with self._cond:
                while not self._frames and not self._closed:
                    self._cond.wait()
                if self._closed:
                    return
                frame = self._frames.popleft()
                self._bytes -= len(frame)
                self._sending = True
            try:
                self._sock.sendall(frame)
            except OSError:
                with self._cond:  # the driver is gone
                    self._dead = True
                    self.dropped += 1 + len(self._frames)
                    self._frames.clear()
                    self._bytes = 0
            finally:
                with self._cond:
                    self._sending = False
                    self._cond.notify_all()
            if self._dead:
                return

    def flush(self, timeout=LOG_FLUSH_S):
        """Wait up to ``timeout`` seconds for every queued frame to be
        sent; True when the ring drained."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while (self._frames or self._sending) and not self._dead:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cond.wait(left)
            return True

    def close(self):
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()


class ControlPlaneClient:
    """A worker's end: one authenticated socket to the driver for the
    frames that must arrive (a send is one ``sendall`` under a lock),
    and a :class:`LogRing` on a second one for the tee'd stdout and
    stderr lines."""

    def __init__(self, address, rank, secret):
        host, port = address.rsplit(":", 1)
        self.rank = rank
        auth = auth_frame(secret, rank)
        self._sock = socket.create_connection((host, int(port)), timeout=30)
        self._sock.settimeout(None)
        self._sock.sendall(auth)
        self._lock = threading.Lock()
        self._closing = False
        # the capture service's entry for PROFILE_REQ (None: dropped)
        self._profile_handler = None
        # a gang replica's serving loop's entry for SERVE_REQ (None:
        # dropped)
        self._serve_handler = None
        self._logs = LogRing(host, int(port), auth)

    @property
    def log_dropped(self):
        """LOG frames dropped so far (a driver slow to read)."""
        return self._logs.dropped

    def _send(self, mtype, payload):
        # the fault injection may drop or delay a frame (inert unless a
        # chaos setting is set); the log ring's frames are droppable by
        # design and not hooked
        from sparkdl_tpu_torch.utils.chaos import control_frame_fate

        fate = control_frame_fate(_MSG_NAMES.get(mtype, str(mtype)))
        if fate == "drop":
            return
        if fate:
            time.sleep(fate)
        frame = _HEADER.pack(len(payload) + 5, mtype, self.rank) + payload
        with self._lock:
            try:
                self._sock.sendall(frame)
            except OSError:
                pass  # the driver is gone; its launcher reaps this worker

    def _send_json(self, mtype, obj):
        self._send(mtype, json.dumps(obj).encode("utf-8"))

    def send_ready(self):
        self._send(MSG_READY, b"")

    def send_log(self, stream, text):
        """A tee'd line into the log ring: never blocks."""
        payload = json.dumps({"stream": stream,
                              "text": text[:MAX_LOG_TEXT]}).encode("utf-8")
        self._logs.send(_HEADER.pack(len(payload) + 5, MSG_LOG, self.rank)
                        + payload)

    def send_user_log(self, text):
        # log_to_driver is explicit and low-rate: the guaranteed socket
        self._send_json(MSG_USERLOG, {"text": text[:MAX_LOG_TEXT]})

    def send_telemetry(self, payload_obj):
        # a flush: the guaranteed socket, never the droppable log ring
        self._send_json(MSG_TELEMETRY, payload_obj)

    def send_heartbeat(self, payload_obj):
        # a beat must go on while the training thread is wedged: the
        # guaranteed socket, and no flush of the log ring first
        self._send_json(MSG_HEARTBEAT, payload_obj)

    def _answer_dump_request(self, payload):
        """A STACK_DUMP of every thread, sent from the watchdog thread:
        faulthandler reads each thread's frames without their help."""
        from sparkdl_tpu_torch.observe.health import dump_all_threads

        try:
            reason = json.loads(payload.decode("utf-8", "replace")).get(
                "reason", "requested")
        except (ValueError, AttributeError):
            reason = "requested"
        try:
            dump = dump_all_threads()
        except Exception:
            dump = "<faulthandler dump failed>\n" + traceback.format_exc()
        self._send_json(MSG_STACK_DUMP, {"reason": reason, "dump": dump})

    def set_profile_handler(self, handler):
        """Register the capture service's entry for the driver's
        PROFILE_REQ frames, ``handler(request_dict)``, called on the
        watchdog thread (it hands the capture to a thread of its own);
        None unregisters."""
        self._profile_handler = handler

    def send_profile_done(self, report_meta):
        """Answer a PROFILE_REQ: the finished (or failed) capture's
        metadata, on the guaranteed socket."""
        self._send_json(MSG_PROFILE_DONE, report_meta)

    def _dispatch_profile_request(self, payload):
        """One PROFILE_REQ to the registered capture service; without one
        the frame is dropped: no error, no work."""
        handler = self._profile_handler
        if handler is None:
            return
        try:
            req = json.loads(payload.decode("utf-8", "replace"))
        except ValueError:
            req = {}
        if not isinstance(req, dict):
            req = {}
        try:
            handler(req)
        except Exception:
            pass  # the watchdog keeps watching, whatever the service does

    def set_serve_handler(self, handler):
        """Register a gang replica's entry for the driver's SERVE_REQ
        frames, ``handler(request_dict)``, called on the watchdog
        thread; None unregisters."""
        self._serve_handler = handler

    def send_serve(self, obj):
        """SERVE_OUT to the driver: ``obj`` as JSON, on the guaranteed
        socket."""
        self._send_json(MSG_SERVE_OUT, obj)

    def _dispatch_serve_request(self, payload):
        handler = self._serve_handler
        if handler is None:
            return
        try:
            req = json.loads(payload.decode("utf-8", "replace"))
        except ValueError:
            return
        if isinstance(req, dict):
            handler(req)

    def send_result(self, pickled_bytes):
        self._logs.flush()  # the run's last lines reach the driver first
        if len(pickled_bytes) <= RESULT_CHUNK:
            self._send(MSG_RESULT, pickled_bytes)
            return
        view = memoryview(pickled_bytes)
        for off in range(0, len(view), RESULT_CHUNK):
            self._send(MSG_RESULT_PART, bytes(view[off:off + RESULT_CHUNK]))
        self._send(MSG_RESULT_END, b"")

    def send_exception(self, tb_text):
        if len(tb_text) > MAX_TRACEBACK:
            tb_text = "...[truncated]...\n" + tb_text[-MAX_TRACEBACK:]
        self._logs.flush()
        self._send_json(MSG_EXC, {"traceback": tb_text})

    def send_bye(self, exit_code):
        self._logs.flush()
        self._send_json(MSG_BYE, {"exit_code": exit_code,
                                  "log_dropped": self._logs.dropped})

    def start_driver_watchdog(self, grace_seconds=10.0):
        """Exit this worker when the driver's end of the socket closes
        (the driver died, even by SIGKILL): no worker outlives its
        driver, holding its card. Meanwhile answer the driver's DUMP_REQ
        frames, hand its PROFILE_REQ frames to the capture service and
        its SERVE_REQ frames to a gang replica's serving loop, the only
        frames it sends."""

        def watch():
            try:
                while True:
                    head = _recv_exact(self._sock, _HEADER.size)
                    if head is None:
                        break
                    length, mtype, _ = _HEADER.unpack(head)
                    if length < 5 or length - 5 > MAX_FRAME:
                        break  # unframeable: as a reset
                    payload = _recv_exact(self._sock, length - 5)
                    if payload is None:
                        break
                    if mtype == MSG_DUMP_REQ:
                        self._answer_dump_request(payload)
                    elif mtype == MSG_PROFILE_REQ:
                        self._dispatch_profile_request(payload)
                    elif mtype == MSG_SERVE_REQ:
                        self._dispatch_serve_request(payload)
            except OSError:
                pass
            if self._closing:
                return  # our own close(): a finished worker
            sys.stderr.write("hvd worker: driver connection lost; exiting "
                             f"in {grace_seconds:.0f}s\n")
            sys.stderr.flush()
            time.sleep(grace_seconds)
            if not self._closing:
                os._exit(83)

        threading.Thread(target=watch, name="hvd-driver-watchdog",
                         daemon=True).start()

    def close(self):
        self._closing = True  # before the socket: not a driver death
        self._logs.close()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()


_worker_client = None
_worker_client_lock = threading.Lock()


@contextlib.contextmanager
def worker_client(client):
    """``client`` as this process's client (what :func:`get_worker_client`
    and ``log_to_driver`` use) for the length of the block: a process
    that runs one rank after another (a reused Spark worker) sends each
    rank's frames to its own job's driver."""
    global _worker_client
    with _worker_client_lock:
        _worker_client = client
    try:
        yield client
    finally:
        with _worker_client_lock:
            _worker_client = None


def get_worker_client():
    """The process's client, or None outside a HorovodRunner worker
    (then the driver is this process and ``log_to_driver`` prints)."""
    global _worker_client
    with _worker_client_lock:
        if _worker_client is None:
            addr = os.environ.get(CONTROL_ADDR_ENV)
            if not addr:
                return None
            secret = os.environ.get(CONTROL_SECRET_ENV)
            if not secret:
                raise RuntimeError(
                    f"{CONTROL_ADDR_ENV} is set but {CONTROL_SECRET_ENV} is "
                    "not: refusing an unauthenticated channel to the driver")
            _worker_client = ControlPlaneClient(
                addr, int(os.environ.get("RANK", "0")), secret)
        return _worker_client
