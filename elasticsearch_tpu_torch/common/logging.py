"""Logging facade (a trimmed copy of the JAX package's `common/logging.py`):
component loggers under the port's own root, `estpu_torch`, so a process
that runs both packages never shares handlers or levels between them, with
the optional node and shard prefixes that tell apart two nodes' lines in
one process. (The JAX module's `set_level` and `apply_logger_settings`
have no caller in either package.)"""

from __future__ import annotations

import logging
import sys

_ROOT = "estpu_torch"
_configured = False


def _ensure_configured():
    global _configured
    if _configured:
        return
    root = logging.getLogger(_ROOT)
    if not root.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(
            logging.Formatter("[%(asctime)s][%(levelname)-5s][%(name)s] %(message)s",
                              "%Y-%m-%dT%H:%M:%S")
        )
        root.addHandler(h)
        root.setLevel(logging.INFO)
        root.propagate = False
    _configured = True


class PrefixLogger(logging.LoggerAdapter):
    def process(self, msg, kwargs):
        return f"{self.extra['prefix']} {msg}", kwargs


def get_logger(component: str, node: str | None = None, shard=None):
    """`get_logger("index.engine", node="node_1", shard=("idx", 3))` → the
    logger estpu_torch.index.engine, its lines prefixed "[node_1][idx][3]"."""
    _ensure_configured()
    logger = logging.getLogger(f"{_ROOT}.{component}")
    prefix_parts = []
    if node:
        prefix_parts.append(f"[{node}]")
    if shard is not None:
        index, shard_id = shard
        prefix_parts.append(f"[{index}][{shard_id}]")
    if prefix_parts:
        return PrefixLogger(logger, {"prefix": "".join(prefix_parts)})
    return logger

