"""Content formats of REST bodies (a trimmed copy of the JAX package's
`common/xcontent.py`): JSON only. The HTTP layer names a body's format from
its Content-Type, else by sniffing its first bytes as the JAX package does,
so a SMILE, CBOR or YAML body is recognised and refused with a 400 (those
codecs are a later slice of the port) instead of being misread as JSON."""

from __future__ import annotations

import json

from .errors import NotPortedError

JSON, SMILE, YAML, CBOR = "json", "smile", "yaml", "cbor"

_SMILE_HEADER = b":)\n"


def from_content_type(ctype: str) -> str | None:
    c = (ctype or "").lower()
    for fmt in (SMILE, CBOR, YAML, JSON):
        if fmt in c:
            return fmt
    return None


def detect(raw: bytes) -> str:
    """The JAX package's sniffing order: the SMILE magic, the CBOR
    self-describe tag, JSON by a leading `{` / `[`, a CBOR map or array head,
    YAML by `---`, else JSON."""
    if raw.startswith(_SMILE_HEADER):
        return SMILE
    if raw.startswith(b"\xd9\xd9\xf7"):
        return CBOR
    head = raw.lstrip()[:3]
    if head[:1] in (b"{", b"["):
        return JSON
    if raw[:1] and (raw[0] >> 5) in (4, 5):
        return CBOR
    if head.startswith(b"---"):
        return YAML
    return JSON


def loads(raw: bytes, fmt: str = JSON):
    if fmt != JSON:
        raise NotPortedError(
            f"[{fmt}] request bodies are not ported yet (a later slice of the "
            "port); send JSON")
    return json.loads(raw)
