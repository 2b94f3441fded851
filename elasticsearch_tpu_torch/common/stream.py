"""Binary wire/storage codec (a copy of the JAX package's `common/stream.py`,
byte for byte on the values it writes): variable-length ints, length-prefixed
UTF-8 strings, optional strings and tagged generic values. The translog's
records and every transport message go through it, so the port's translog
files read back with the JAX package's reader and the other way round.

Tag 7 (a tracing context) belongs to the tracing slice of the port; this
codec refuses it."""

from __future__ import annotations

import io
import struct
from typing import Any

from .errors import SearchEngineError

_NULL = 0xFF


class StreamOutput:
    __slots__ = ("_buf",)

    def __init__(self):
        self._buf = io.BytesIO()

    def write_byte(self, b: int):
        self._buf.write(bytes((b & 0xFF,)))

    def write_bool(self, v: bool):
        self.write_byte(1 if v else 0)

    def write_double(self, v: float):
        self._buf.write(struct.pack(">d", v))

    def write_vint(self, v: int):
        """Unsigned varint, 7 bits per byte, low group first."""
        assert v >= 0, v
        while v & ~0x7F:
            self.write_byte((v & 0x7F) | 0x80)
            v >>= 7
        self.write_byte(v)

    def write_zlong(self, v: int):
        """Zig-zag signed varint."""
        self.write_vint((v << 1) if v >= 0 else ((-v) << 1) - 1)

    def write_bytes(self, b: bytes):
        self.write_vint(len(b))
        self._buf.write(b)

    def write_string(self, s: str):
        self.write_bytes(s.encode("utf-8"))

    def write_optional_string(self, s: str | None):
        if s is None:
            self.write_bool(False)
        else:
            self.write_bool(True)
            self.write_string(s)

    def write_value(self, v: Any):
        """Tagged any-value encoding (the JAX codec's tags 0-6)."""
        if v is None:
            self.write_byte(_NULL)
        elif isinstance(v, bool):
            self.write_byte(0)
            self.write_bool(v)
        elif isinstance(v, int):
            self.write_byte(1)
            self.write_zlong(v)
        elif isinstance(v, float):
            self.write_byte(2)
            self.write_double(v)
        elif isinstance(v, str):
            self.write_byte(3)
            self.write_string(v)
        elif isinstance(v, bytes):
            self.write_byte(4)
            self.write_bytes(v)
        elif isinstance(v, (list, tuple)):
            self.write_byte(5)
            self.write_vint(len(v))
            for item in v:
                self.write_value(item)
        elif isinstance(v, dict):
            self.write_byte(6)
            self.write_vint(len(v))
            for k, item in v.items():
                self.write_string(str(k))
                self.write_value(item)
        else:
            raise SearchEngineError(f"cannot serialize value of type {type(v)}")

    def bytes(self) -> bytes:
        return self._buf.getvalue()


class StreamInput:
    __slots__ = ("_buf",)

    def __init__(self, data: bytes):
        self._buf = io.BytesIO(data)

    def _read(self, n: int) -> bytes:
        b = self._buf.read(n)
        if len(b) != n:
            raise SearchEngineError("unexpected end of stream")
        return b

    def read_byte(self) -> int:
        return self._read(1)[0]

    def read_bool(self) -> bool:
        return self.read_byte() != 0

    def read_double(self) -> float:
        return struct.unpack(">d", self._read(8))[0]

    def read_vint(self) -> int:
        out = 0
        shift = 0
        while True:
            b = self.read_byte()
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7

    def read_zlong(self) -> int:
        v = self.read_vint()
        return (v >> 1) if not v & 1 else -((v + 1) >> 1)

    def read_bytes(self) -> bytes:
        return self._read(self.read_vint())

    def read_string(self) -> str:
        return self.read_bytes().decode("utf-8")

    def read_optional_string(self) -> str | None:
        return self.read_string() if self.read_bool() else None

    def read_value(self) -> Any:
        tag = self.read_byte()
        if tag == _NULL:
            return None
        if tag == 0:
            return self.read_bool()
        if tag == 1:
            return self.read_zlong()
        if tag == 2:
            return self.read_double()
        if tag == 3:
            return self.read_string()
        if tag == 4:
            return self.read_bytes()
        if tag == 5:
            return [self.read_value() for _ in range(self.read_vint())]
        if tag == 6:
            return {self.read_string(): self.read_value()
                    for _ in range(self.read_vint())}
        raise SearchEngineError(f"unknown value tag {tag}")
