"""CLI launcher: `python -m elasticsearch_tpu_torch [options]` (a copy of
the JAX package's `__main__.py`): prepare the settings (a YAML config file,
then the -D overrides), build a port Node on the card, join or form the
cluster over the TCP transport, serve REST over HTTP, and block until
SIGINT/SIGTERM.

  -Dkey=value          setting override (repeatable; e.g. -Dnode.name=n1,
                       -Dnode.device=cpu to serve from the host)
  --config PATH        elasticsearch.yml-style settings file
  --data PATH          data directory (path.data; a fresh one each run)
  --http-port N        REST port (default 9200; 0 = ephemeral)
  --transport tcp|local
  --seeds host:port,…  unicast discovery seeds (another node's transport)

It prints `node [<name>] started on [<device>] — transport <address>, http
port <port>` once it serves. Without a card and without `-Dnode.device=cpu`
it raises: it does not serve from the host."""

from __future__ import annotations

import argparse
import signal
import sys
import threading


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="estpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-D", action="append", default=[], metavar="key=value",
                    dest="defines")
    ap.add_argument("--config", default=None)
    ap.add_argument("--data", default=None)
    ap.add_argument("--http-port", type=int, default=9200)
    ap.add_argument("--transport", choices=("tcp", "local"), default="tcp")
    ap.add_argument("--seeds", default=None)
    args = ap.parse_args(argv)

    settings: dict = {}
    if args.config:
        import yaml

        with open(args.config) as f:
            settings.update(yaml.safe_load(f) or {})
    for d in args.defines:
        key, _, value = d.partition("=")
        settings[key] = value
    settings.setdefault("transport.type", args.transport)
    settings.setdefault("http.enabled", True)
    settings.setdefault("http.port", args.http_port)
    if args.seeds:
        settings.setdefault("discovery.zen.ping.unicast.hosts",
                            [s.strip() for s in args.seeds.split(",") if s.strip()])

    from .node import Node

    node = Node(settings=settings, data_path=args.data)
    seeds = settings.get("discovery.zen.ping.unicast.hosts")
    node.start(seeds=list(seeds) if seeds else [])

    stop = threading.Event()

    def shutdown(_sig, _frm):
        stop.set()

    signal.signal(signal.SIGINT, shutdown)
    signal.signal(signal.SIGTERM, shutdown)
    addr = node.local_node.transport_address
    port = node.http.port if node.http else None
    print(f"[estpu_torch] node [{node.name}] started on [{node.device}] — "
          f"transport {addr}, http port {port}", flush=True)
    stop.wait()
    print("[estpu_torch] shutting down", flush=True)
    node.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
