"""Per-shard write-ahead log (a copy of the JAX package's `index/translog.py`,
byte-compatible: the JAX `Translog` reads the port's files back to the same
ops and the other way round).

Every engine mutation is appended before it is acknowledged, replayed on
recovery, and rolled at each flush. Records are length-prefixed,
CRC-checked frames of the wire codec, so a torn tail write is detected and
truncated, not replayed. Auto-flush thresholds: 5k ops or 200MB."""

from __future__ import annotations

import os
import struct
import threading
import zlib

from ..common.stream import StreamInput, StreamOutput

CREATE, INDEX, DELETE = 1, 2, 3

FLUSH_THRESHOLD_OPS = 5000
FLUSH_THRESHOLD_SIZE = 200 * 1024 * 1024


class TranslogOp:
    """One logged operation; `query`, `parent`, `timestamp` and `ttl` are
    written for the JAX package's record layout (delete-by-query and the
    time meta-fields are later slices of the port, so they stay None)."""

    __slots__ = ("op", "type", "id", "source", "routing", "version", "query",
                 "parent", "timestamp", "ttl")

    def __init__(self, op: int, type: str = "", id: str = "", source: dict | None = None,
                 routing: str | None = None, version: int = 1, query: dict | None = None,
                 parent: str | None = None, timestamp=None, ttl=None):
        self.op = op
        self.type = type
        self.id = id
        self.source = source
        self.routing = routing
        self.version = version
        self.query = query
        self.parent = parent
        self.timestamp = timestamp
        self.ttl = ttl

    def encode(self) -> bytes:
        out = StreamOutput()
        out.write_byte(self.op)
        out.write_string(self.type)
        out.write_string(self.id)
        out.write_value(self.source)
        out.write_optional_string(self.routing)
        out.write_zlong(self.version)
        out.write_value(self.query)
        out.write_optional_string(self.parent)
        out.write_value(self.timestamp)
        out.write_value(self.ttl)
        return out.bytes()

    @classmethod
    def decode(cls, data: bytes) -> "TranslogOp":
        inp = StreamInput(data)
        return cls(op=inp.read_byte(), type=inp.read_string(), id=inp.read_string(),
                   source=inp.read_value(), routing=inp.read_optional_string(),
                   version=inp.read_zlong(), query=inp.read_value(),
                   parent=inp.read_optional_string(), timestamp=inp.read_value(),
                   ttl=inp.read_value())


class Translog:
    """Appends framed ops to `translog-<gen>.log`; a new generation starts at
    each commit (roll). Frame = [len u32][crc u32][payload]."""

    def __init__(self, path: str, gen: int | None = None):
        self.dir = path
        os.makedirs(path, exist_ok=True)
        if gen is None:
            gen = max(self._gens(), default=1)
        self.gen = gen
        self._lock = threading.Lock()
        self._ops = 0
        self._fh = open(self._file(gen), "ab")
        self._size = self._fh.tell()

    def _gens(self) -> list[int]:
        return sorted(int(n[len("translog-"):-len(".log")])
                      for n in os.listdir(self.dir)
                      if n.startswith("translog-") and n.endswith(".log"))

    def _file(self, gen: int) -> str:
        return os.path.join(self.dir, f"translog-{gen}.log")

    def set_gen(self, gen: int):
        """Re-point the active generation (recovery from a commit point)."""
        with self._lock:
            if gen == self.gen:
                return
            self._fh.close()
            self.gen = gen
            self._fh = open(self._file(gen), "ab")
            self._ops = 0
            self._size = self._fh.tell()

    def add(self, op: TranslogOp) -> None:
        payload = op.encode()
        frame = struct.pack(">II", len(payload), zlib.crc32(payload) & 0xFFFFFFFF) + payload
        with self._lock:
            self._fh.write(frame)
            self._ops += 1
            self._size += len(frame)

    def sync(self):
        with self._lock:
            self._fh.flush()
            os.fsync(self._fh.fileno())

    @property
    def ops_count(self) -> int:
        return self._ops

    def should_flush(self) -> bool:
        return self._ops >= FLUSH_THRESHOLD_OPS or self._size >= FLUSH_THRESHOLD_SIZE

    def roll(self) -> int:
        """Start a new generation (at engine flush); returns the new gen."""
        with self._lock:
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._fh.close()
            self.gen += 1
            self._fh = open(self._file(self.gen), "ab")
            self._ops = 0
            self._size = 0
            return self.gen

    def prune_before(self, gen: int):
        for g in self._gens():
            if g < gen:
                os.unlink(self._file(g))

    def read_ops(self, from_gen: int | None = None) -> list[TranslogOp]:
        """Every op from generation `from_gen` (default: the current one) on;
        stops cleanly at a torn or corrupt tail frame."""
        ops: list[TranslogOp] = []
        with self._lock:
            self._fh.flush()
        start = from_gen if from_gen is not None else self.gen
        for g in self._gens():
            if g < start:
                continue
            with open(self._file(g), "rb") as f:
                data = f.read()
            off = 0
            while off + 8 <= len(data):
                length, crc = struct.unpack_from(">II", data, off)
                if off + 8 + length > len(data):
                    break  # torn tail
                payload = data[off + 8: off + 8 + length]
                if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                    break  # corrupt tail — stop replay here
                ops.append(TranslogOp.decode(payload))
                off += 8 + length
        return ops

    def close(self):
        with self._lock:
            try:
                self._fh.flush()
                self._fh.close()
            except ValueError:
                pass
