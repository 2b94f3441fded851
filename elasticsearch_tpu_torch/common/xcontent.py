"""Content formats of REST bodies (a copy of the JAX package's
`common/xcontent.py`): JSON, SMILE, YAML and CBOR, each a small codec over
Python objects.

- JSON: the standard library (the lenient variant is handled at the REST
  layer)
- YAML: PyYAML's safe load and dump, imported when a YAML body or response
  comes (a host without PyYAML answers such a body 400 and such a response
  500, as the HTTP layer answers any body that does not decode and any
  response that does not encode)
- CBOR: an RFC 7049 encoder and decoder (major types 0-7, the
  JSON-compatible subset; integers past 64 bits as bignum tags)
- SMILE: Jackson's binary JSON (`:)\n` header), with the shared-name and
  shared-value back-references disabled in the header flags

The encodings are byte for byte the JAX package's. Detection mirrors the
reference's XContentFactory: SMILE by its `:)` magic, CBOR by the
self-describe tag or a leading map or array head, JSON by `{` or `[`, YAML
by `---`, else JSON."""

from __future__ import annotations

import json
import math
import struct

JSON, SMILE, YAML, CBOR = "json", "smile", "yaml", "cbor"

CONTENT_TYPES = {
    JSON: "application/json",
    SMILE: "application/smile",
    YAML: "application/yaml",
    CBOR: "application/cbor",
}

_SMILE_HEADER = b":)\n"


def from_content_type(ctype: str) -> str | None:
    c = (ctype or "").lower()
    if "smile" in c:
        return SMILE
    if "cbor" in c:
        return CBOR
    if "yaml" in c:
        return YAML
    if "json" in c:
        return JSON
    return None


def detect(raw: bytes) -> str:
    """Format sniffing (ref: XContentFactory.xContent(byte[]))."""
    if raw.startswith(_SMILE_HEADER):
        return SMILE
    if raw.startswith(b"\xd9\xd9\xf7"):  # CBOR self-describe tag 55799
        return CBOR
    head = raw.lstrip()[:3]
    if head[:1] in (b"{", b"["):
        return JSON
    if raw[:1] and (raw[0] >> 5) in (4, 5):
        # leading array/map major type — binary CBOR bodies from clients (no
        # printable-ASCII collision: 0x80+ is never a JSON/YAML first byte)
        return CBOR
    if head.startswith(b"---"):
        return YAML
    return JSON


def loads(raw: bytes, fmt: str):
    if fmt == JSON:
        return json.loads(raw.decode())
    if fmt == YAML:
        import yaml as _yaml

        return _yaml.safe_load(raw.decode())
    if fmt == CBOR:
        return cbor_loads(raw)
    if fmt == SMILE:
        return smile_loads(raw)
    raise ValueError(f"unknown xcontent format [{fmt}]")


def dumps(obj, fmt: str) -> bytes:
    if fmt == JSON:
        return json.dumps(obj).encode()
    if fmt == YAML:
        import yaml as _yaml

        return _yaml.safe_dump(obj, sort_keys=False).encode()
    if fmt == CBOR:
        return cbor_dumps(obj)
    if fmt == SMILE:
        return smile_dumps(obj)
    raise ValueError(f"unknown xcontent format [{fmt}]")


# ---------------------------------------------------------------------------
# CBOR (RFC 7049)
# ---------------------------------------------------------------------------


def _cbor_head(major: int, arg: int) -> bytes:
    if arg < 24:
        return bytes([(major << 5) | arg])
    if arg < 0x100:
        return bytes([(major << 5) | 24, arg])
    if arg < 0x10000:
        return bytes([(major << 5) | 25]) + arg.to_bytes(2, "big")
    if arg < 0x100000000:
        return bytes([(major << 5) | 26]) + arg.to_bytes(4, "big")
    return bytes([(major << 5) | 27]) + arg.to_bytes(8, "big")


def cbor_dumps(obj) -> bytes:
    out = bytearray()
    _cbor_enc(obj, out)
    return bytes(out)


def _cbor_enc(obj, out: bytearray):
    if obj is None:
        out.append(0xF6)
    elif obj is True:
        out.append(0xF5)
    elif obj is False:
        out.append(0xF4)
    elif isinstance(obj, int):
        if 0 <= obj < (1 << 64):
            out += _cbor_head(0, obj)
        elif -(1 << 64) <= obj < 0:
            out += _cbor_head(1, -1 - obj)
        else:  # RFC 7049 bignum: tag 2 (positive) / 3 (negative) + byte string
            n = obj if obj >= 0 else -1 - obj
            b = n.to_bytes((n.bit_length() + 7) // 8 or 1, "big")
            out += _cbor_head(6, 2 if obj >= 0 else 3)
            out += _cbor_head(2, len(b))
            out += b
    elif isinstance(obj, float):
        out.append(0xFB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, bytes):
        out += _cbor_head(2, len(obj))
        out += obj
    elif isinstance(obj, str):
        b = obj.encode()
        out += _cbor_head(3, len(b))
        out += b
    elif isinstance(obj, (list, tuple)):
        out += _cbor_head(4, len(obj))
        for v in obj:
            _cbor_enc(v, out)
    elif isinstance(obj, dict):
        out += _cbor_head(5, len(obj))
        for k, v in obj.items():
            _cbor_enc(str(k), out)
            _cbor_enc(v, out)
    else:
        raise TypeError(f"cbor cannot encode {type(obj).__name__}")


def cbor_loads(raw: bytes):
    v, i = _cbor_dec(raw, 0)
    return v


def _cbor_arg(raw: bytes, i: int, info: int) -> tuple[int, int]:
    if info < 24:
        return info, i
    if info == 24:
        return raw[i], i + 1
    if info == 25:
        return int.from_bytes(raw[i: i + 2], "big"), i + 2
    if info == 26:
        return int.from_bytes(raw[i: i + 4], "big"), i + 4
    if info == 27:
        return int.from_bytes(raw[i: i + 8], "big"), i + 8
    if info == 31:
        return -1, i  # indefinite length
    raise ValueError(f"cbor: bad additional info {info}")


def _cbor_dec(raw: bytes, i: int):
    b = raw[i]
    i += 1
    major, info = b >> 5, b & 0x1F
    if major == 0:
        return _cbor_arg(raw, i, info)
    if major == 1:
        n, i = _cbor_arg(raw, i, info)
        return -1 - n, i
    if major == 2 or major == 3:
        n, i = _cbor_arg(raw, i, info)
        if n < 0:  # indefinite: concatenate chunks until break
            parts = []
            while raw[i] != 0xFF:
                p, i = _cbor_dec(raw, i)
                parts.append(p if isinstance(p, (bytes, str)) else bytes(p))
            i += 1
            joined = b"".join(p.encode() if isinstance(p, str) else p for p in parts)
            return joined.decode() if major == 3 else joined, i
        chunk = raw[i: i + n]
        i += n
        return (chunk.decode() if major == 3 else bytes(chunk)), i
    if major == 4:
        n, i = _cbor_arg(raw, i, info)
        out = []
        if n < 0:
            while raw[i] != 0xFF:
                v, i = _cbor_dec(raw, i)
                out.append(v)
            return out, i + 1
        for _ in range(n):
            v, i = _cbor_dec(raw, i)
            out.append(v)
        return out, i
    if major == 5:
        n, i = _cbor_arg(raw, i, info)
        d = {}
        if n < 0:
            while raw[i] != 0xFF:
                k, i = _cbor_dec(raw, i)
                v, i = _cbor_dec(raw, i)
                d[k] = v
            return d, i + 1
        for _ in range(n):
            k, i = _cbor_dec(raw, i)
            v, i = _cbor_dec(raw, i)
            d[k] = v
        return d, i
    if major == 6:
        tag, i = _cbor_arg(raw, i, info)
        v, i = _cbor_dec(raw, i)
        if tag == 2 and isinstance(v, bytes):  # positive bignum
            return int.from_bytes(v, "big"), i
        if tag == 3 and isinstance(v, bytes):  # negative bignum
            return -1 - int.from_bytes(v, "big"), i
        return v, i  # other tags (incl. self-describe) are transparent
    # major 7
    if info == 20:
        return False, i
    if info == 21:
        return True, i
    if info == 22 or info == 23:
        return None, i
    if info == 25:  # half float
        h = int.from_bytes(raw[i: i + 2], "big")
        i += 2
        sign = -1.0 if h & 0x8000 else 1.0
        exp = (h >> 10) & 0x1F
        frac = h & 0x3FF
        if exp == 0:
            val = frac * 2 ** -24
        elif exp == 31:
            val = math.inf if frac == 0 else math.nan
        else:
            val = (1 + frac * 2 ** -10) * 2 ** (exp - 15)
        return sign * val, i
    if info == 26:
        return struct.unpack(">f", raw[i: i + 4])[0], i + 4
    if info == 27:
        return struct.unpack(">d", raw[i: i + 8])[0], i + 8
    raise ValueError(f"cbor: bad simple value {info}")


# ---------------------------------------------------------------------------
# SMILE (Jackson binary JSON; shared references disabled)
# ---------------------------------------------------------------------------


def _smile_vint(n: int) -> bytes:
    """Smile VInt: big-endian 7-bit groups, LAST byte holds 6 bits + 0x80 marker."""
    out = [0x80 | (n & 0x3F)]
    n >>= 6
    while n:
        out.append(n & 0x7F)
        n >>= 7
    return bytes(reversed(out))


def _smile_read_vint(raw: bytes, i: int) -> tuple[int, int]:
    n = 0
    while True:
        b = raw[i]
        i += 1
        if b & 0x80:
            return (n << 6) | (b & 0x3F), i
        n = (n << 7) | b


def _zigzag(n: int) -> int:
    # arbitrary precision (Python ints are unbounded; a fixed 64-bit shift would
    # silently corrupt values beyond int64)
    return ((-n - 1) << 1) | 1 if n < 0 else n << 1


def _unzigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def _7bit_pack(data: bytes) -> bytes:
    """Big-endian 7-bits-per-byte expansion (floats travel this way in smile)."""
    n = int.from_bytes(data, "big")
    nbytes = (len(data) * 8 + 6) // 7
    return bytes((n >> (7 * (nbytes - 1 - j))) & 0x7F for j in range(nbytes))


def _7bit_unpack(chunk: bytes, nbytes: int) -> bytes:
    n = 0
    for b in chunk:
        n = (n << 7) | (b & 0x7F)
    return n.to_bytes(nbytes, "big") if nbytes else b""


def smile_dumps(obj) -> bytes:
    out = bytearray(_SMILE_HEADER)
    out.append(0x00)  # version 0; no raw binary, no shared names/values
    _smile_value(obj, out)
    return bytes(out)


def _smile_value(obj, out: bytearray):
    if obj is None:
        out.append(0x21)
    elif obj is True:
        out.append(0x23)
    elif obj is False:
        out.append(0x22)
    elif isinstance(obj, int):
        z = _zigzag(obj)
        if -16 <= obj <= 15:
            out.append(0xC0 + z)
        elif -(1 << 31) <= obj < (1 << 31):
            out.append(0x24)
            out += _smile_vint(z)
        else:
            # int64 token; beyond-64-bit values keep the same vint encoding (our
            # decoder reads it losslessly; spec BigInteger token not emitted)
            out.append(0x25)
            out += _smile_vint(z)
    elif isinstance(obj, float):
        out.append(0x29)
        out += _7bit_pack(struct.pack(">d", obj))
    elif isinstance(obj, str):
        b = obj.encode()
        is_ascii = len(b) == len(obj)
        if not obj:
            out.append(0x20)
        elif is_ascii and len(b) <= 32:
            out.append(0x40 + len(b) - 1)
            out += b
        elif is_ascii and len(b) <= 64:
            out.append(0x60 + len(b) - 33)
            out += b
        elif not is_ascii and 2 <= len(b) <= 33:
            out.append(0x80 + len(b) - 2)
            out += b
        elif not is_ascii and 34 <= len(b) <= 65:
            out.append(0xA0 + len(b) - 34)
            out += b
        else:
            out.append(0xE0 if is_ascii else 0xE4)
            out += b
            out.append(0xFC)  # string end marker
    elif isinstance(obj, (list, tuple)):
        out.append(0xF8)
        for v in obj:
            _smile_value(v, out)
        out.append(0xF9)
    elif isinstance(obj, dict):
        out.append(0xFA)
        for k, v in obj.items():
            _smile_key(str(k), out)
            _smile_value(v, out)
        out.append(0xFB)
    else:
        raise TypeError(f"smile cannot encode {type(obj).__name__}")


def _smile_key(key: str, out: bytearray):
    b = key.encode()
    is_ascii = len(b) == len(key)
    if not key:
        out.append(0x20)
    elif is_ascii and len(b) <= 64:
        out.append(0x80 + len(b) - 1)
        out += b
    elif not is_ascii and 2 <= len(b) <= 57:
        out.append(0xC0 + len(b) - 2)
        out += b
    else:
        out.append(0x34)  # long name
        out += b
        out.append(0xFC)


def smile_loads(raw: bytes):
    if not raw.startswith(_SMILE_HEADER):
        raise ValueError("not a smile document (missing :)\\n header)")
    v, _i = _smile_read_value(raw, 4)
    return v


def _smile_read_value(raw: bytes, i: int):
    t = raw[i]
    i += 1
    if t == 0x20:
        return "", i
    if t == 0x21:
        return None, i
    if t == 0x22:
        return False, i
    if t == 0x23:
        return True, i
    if t in (0x24, 0x25):
        z, i = _smile_read_vint(raw, i)
        return _unzigzag(z), i
    if t == 0x28:  # float32: 5 bytes of 7 bits
        return struct.unpack(">f", _7bit_unpack(raw[i: i + 5], 4))[0], i + 5
    if t == 0x29:  # float64: 10 bytes of 7 bits
        return struct.unpack(">d", _7bit_unpack(raw[i: i + 10], 8))[0], i + 10
    if 0x40 <= t <= 0x5F:
        n = t - 0x40 + 1
        return raw[i: i + n].decode(), i + n
    if 0x60 <= t <= 0x7F:
        n = t - 0x60 + 33
        return raw[i: i + n].decode(), i + n
    if 0x80 <= t <= 0x9F:
        n = t - 0x80 + 2
        return raw[i: i + n].decode(), i + n
    if 0xA0 <= t <= 0xBF:
        n = t - 0xA0 + 34
        return raw[i: i + n].decode(), i + n
    if 0xC0 <= t <= 0xDF:
        return _unzigzag(t - 0xC0), i
    if t in (0xE0, 0xE4):  # long string, 0xFC-terminated
        end = raw.index(0xFC, i)
        return raw[i:end].decode(), end + 1
    if t == 0xF8:
        out = []
        while raw[i] != 0xF9:
            v, i = _smile_read_value(raw, i)
            out.append(v)
        return out, i + 1
    if t == 0xFA:
        d = {}
        while raw[i] != 0xFB:
            k, i = _smile_read_key(raw, i)
            v, i = _smile_read_value(raw, i)
            d[k] = v
        return d, i + 1
    raise ValueError(f"smile: unsupported value token 0x{t:02x} at {i - 1}")


def _smile_read_key(raw: bytes, i: int):
    t = raw[i]
    i += 1
    if t == 0x20:
        return "", i
    if t == 0x34:
        end = raw.index(0xFC, i)
        return raw[i:end].decode(), end + 1
    if 0x80 <= t <= 0xBF:
        n = t - 0x80 + 1
        return raw[i: i + n].decode(), i + n
    if 0xC0 <= t <= 0xF7:
        n = t - 0xC0 + 2
        return raw[i: i + n].decode(), i + n
    raise ValueError(f"smile: unsupported key token 0x{t:02x} at {i - 1}")
