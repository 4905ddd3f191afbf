"""Crash-surviving flight recorder: an mmap-backed ring of a rank's last
timeline events.

Counterpart of ``sparkdl_tpu/observe/flightrec.py``, byte for byte the
same file layout, so either package's :meth:`FlightRecorder.read_tail`
reads the other's rings. A SIGKILL ends a process between two telemetry
flushes; the kernel still writes a ``MAP_SHARED`` mapping's dirty pages
back, so the tail of the rank's story is recoverable from its ring
(merged into the run dir by :mod:`~sparkdl_tpu_torch.observe.aggregate`).

Recording is lock-free: an event claims a slot through a sequence counter
(``itertools.count``, one atomic step under the GIL) and writes it alone;
a write torn by the kill fails JSON validation and is dropped, and the
read orders the slots by their sequence numbers. Each worker process
writes its own ``flightrec-rank-<r>.ring`` in its attempt's job dir.

File layout (little-endian)::

    header: magic "SDTFR1\\0\\0" | u32 slot_size | u32 nslots
    slot i: u64 seq (1-based; 0 = never written) | u32 len | payload

:data:`EVENTS` (slots a ring, the JAX package's
``SPARKDL_TPU_FLIGHTREC_EVENTS``) is a module setting, read when a ring
is opened.
"""

import itertools
import json
import mmap
import os
import struct

MAGIC = b"SDTFR1\x00\x00"
_HEADER = struct.Struct("<8sII")
_SLOT_HEAD = struct.Struct("<QI")

# slots of a new ring (at least 8)
EVENTS = 256
DEFAULT_SLOT_SIZE = 1024

FILE_PREFIX = "flightrec-rank-"
FILE_SUFFIX = ".ring"


def ring_path(job_dir, rank):
    return os.path.join(job_dir, f"{FILE_PREFIX}{int(rank)}{FILE_SUFFIX}")


class FlightRecorder:
    """One process's writer of one ring file."""

    def __init__(self, path, nslots=None, slot_size=DEFAULT_SLOT_SIZE):
        self.path = path
        self.nslots = int(nslots if nslots is not None
                          else max(8, int(EVENTS)))
        self.slot_size = int(slot_size)
        size = _HEADER.size + self.nslots * self.slot_size
        fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o600)
        try:
            os.ftruncate(fd, size)
            self._mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        self._mm[:_HEADER.size] = _HEADER.pack(MAGIC, self.slot_size,
                                               self.nslots)
        self._seq = itertools.count(1)
        self._closed = False

    def record(self, event):
        """Write one timeline event; never raises (an event that cannot
        be serialized, or a closed ring, drops it)."""
        if self._closed:
            return
        try:
            payload = json.dumps(event, default=str).encode("utf-8")
        except (TypeError, ValueError):
            return
        cap = self.slot_size - _SLOT_HEAD.size
        if len(payload) > cap:
            # oversized args: keep the identity fields
            slim = {k: event.get(k) for k in
                    ("name", "cat", "ph", "ts", "dur", "tid") if k in event}
            slim["truncated"] = True
            payload = json.dumps(slim, default=str).encode("utf-8")[:cap]
        seq = next(self._seq)
        off = _HEADER.size + ((seq - 1) % self.nslots) * self.slot_size
        mm = self._mm
        try:
            # the payload before the slot's header: a reader that sees the
            # new (seq, len) sees the new bytes; a kill between the two
            # leaves a record that fails JSON validation
            mm[off + _SLOT_HEAD.size:off + _SLOT_HEAD.size + len(payload)] \
                = payload
            _SLOT_HEAD.pack_into(mm, off, seq, len(payload))
        except (ValueError, IndexError):
            pass  # closed underneath us

    def flush(self):
        try:
            self._mm.flush()
        except (OSError, ValueError):
            pass

    def close(self):
        if self._closed:
            return
        self._closed = True
        self.flush()
        try:
            self._mm.close()
        except (OSError, ValueError):
            pass

    @staticmethod
    def read_tail(path):
        """The ordered event tail of a ring written by a (possibly
        SIGKILLed) process, oldest first; torn slots are dropped. Raises
        ValueError on a file that is not a ring."""
        with open(path, "rb") as f:
            raw = f.read()
        if len(raw) < _HEADER.size:
            raise ValueError(f"{path}: truncated flight-recorder ring")
        magic, slot_size, nslots = _HEADER.unpack_from(raw, 0)
        if magic != MAGIC or slot_size <= _SLOT_HEAD.size or nslots <= 0:
            raise ValueError(f"{path}: not a flight-recorder ring")
        out = []
        for i in range(nslots):
            off = _HEADER.size + i * slot_size
            if off + _SLOT_HEAD.size > len(raw):
                break
            seq, ln = _SLOT_HEAD.unpack_from(raw, off)
            if seq == 0 or ln == 0 or ln > slot_size - _SLOT_HEAD.size:
                continue
            body = raw[off + _SLOT_HEAD.size:off + _SLOT_HEAD.size + ln]
            try:
                ev = json.loads(body.decode("utf-8"))
            except (UnicodeDecodeError, ValueError):
                continue  # a torn write
            if isinstance(ev, dict):
                out.append((seq, ev))
        out.sort(key=lambda t: t[0])
        return [ev for _, ev in out]


def recover_job_dir(job_dir):
    """``{rank: [events...]}`` of every ring in ``job_dir`` (a file that
    cannot be read is skipped: recovery never fails a run dir's
    write)."""
    out = {}
    try:
        names = os.listdir(job_dir)
    except OSError:
        return out
    for name in sorted(names):
        if not (name.startswith(FILE_PREFIX) and name.endswith(FILE_SUFFIX)):
            continue
        try:
            rank = int(name[len(FILE_PREFIX):-len(FILE_SUFFIX)])
            events = FlightRecorder.read_tail(os.path.join(job_dir, name))
        except (ValueError, OSError):
            continue
        out.setdefault(rank, []).extend(events)
    return out
