"""CLI launcher: `python -m elasticsearch_tpu_torch [options]` (a trimmed
copy of the JAX package's `__main__.py`): build a port Node on the card,
elect it master of its one-node cluster, serve REST over HTTP, and block
until SIGINT/SIGTERM.

  -Dkey=value   setting override (repeatable; e.g. -Dnode.name=n1,
                -Dnode.device=cpu to serve from the host)
  --data PATH   data directory (path.data; a fresh one each run)
  --http-port N REST port (default 9200; 0 = ephemeral)

The local transport is the only one in this slice (the JAX launcher's `tcp`
default, seeds and config files come with the slice with two nodes)."""

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
    ap.add_argument("--data", default=None)
    ap.add_argument("--http-port", type=int, default=9200)
    args = ap.parse_args(argv)

    settings: dict = {}
    for d in args.defines:
        key, _, value = d.partition("=")
        settings[key] = value

    from .node import Node

    node = Node(settings=settings, data_path=args.data).start()
    http = node.start_http(args.http_port)
    stop = threading.Event()

    def shutdown(_sig, _frm):
        stop.set()

    signal.signal(signal.SIGINT, shutdown)
    signal.signal(signal.SIGTERM, shutdown)
    print(f"[estpu_torch] node [{node.name}] started on [{node.device}] — "
          f"http port {http.port}", flush=True)
    stop.wait()
    print("[estpu_torch] shutting down", flush=True)
    node.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
