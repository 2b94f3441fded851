"""The port stands alone: importing `elasticsearch_tpu_torch` and every one of
its submodules loads neither `jax` nor any module of the JAX package. Checked
in a fresh interpreter, by exact module name — `elasticsearch_tpu` is a prefix
of the port's own name."""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, json, pkgutil, sys
import elasticsearch_tpu_torch as pkg
names = [pkg.__name__]
for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(info.name)
    names.append(info.name)
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.") or m == "jaxlib"
                or m.startswith("jaxlib.") or m == "elasticsearch_tpu"
                or m.startswith("elasticsearch_tpu."))
print(json.dumps({"imported": names, "leaked": leaked}))
"""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ("search.execute", "convert", "search.batcher",
                 "search.service", "search.controller", "common.breaker",
                 "common.deadline", "node", "actions", "rest.controller",
                 "http.server", "transport.service", "transport.local",
                 "cluster.state", "cluster.service", "cluster.allocation",
                 "cluster.routing", "discovery.zen", "gateway", "threadpool",
                 "index.engine", "index.translog", "index.store",
                 "index.merge_policy", "indices_service", "search.fetch",
                 "common.stream", "common.xcontent", "common.units",
                 "search.filters", "search.queries", "index.segment",
                 "mapper.core", "__main__", "script", "search.functions",
                 "ops.device_index", "ops.scoring", "common.sketches",
                 "search.sorting", "search.aggregations", "warmer",
                 "common.devicehealth", "common.retry", "transport.faults",
                 "percolator", "common.events", "common.metrics",
                 "analysis.core", "search.similarity", "common.names",
                 "common.settings", "common.errors", "search.suggest",
                 "search.request_cache", "cluster.stats", "snapshots"):
        assert f"elasticsearch_tpu_torch.{name}" in report["imported"], name
    assert report["leaked"] == []
