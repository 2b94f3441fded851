"""Logging facade (a trimmed copy of the JAX package's `common/logging.py`):
component loggers under the port's own root, `estpu_torch`, so a process
that runs both packages never shares handlers or levels between them. The
node/shard prefixes and the `logger.*` level settings belong to a later
slice of the port's Node."""

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


def get_logger(component: str) -> logging.Logger:
    """`get_logger("search.batcher")` → the logger estpu_torch.search.batcher."""
    _ensure_configured()
    return logging.getLogger(f"{_ROOT}.{component}")
