"""The port's lock tracer (common/locktrace.py) and the watchdog's
`lock_stall` check over it (common/events.py `_check_locktrace`).

The tracer is armed only in subprocesses (`python -m
tests.test_torch_locktrace <mode>`): installing it patches `threading.Lock`
process-wide, which must never leak into the rest of the suite.

- with the knob off nothing is patched: `maybe_install()` returns None and
  the lock factories stay the standard library's;
- an ABBA script of this file's own (`abba`: two threads take two locks in
  opposite orders, one after the other, so nothing deadlocks) fails with a
  LockOrderViolation naming both inner acquisition sites; its fixed order
  (`fixed`) passes;
- a warmed serving loop on a CPU port node (`serve`: concurrent searches
  through the node's DeviceBatcher, a refresh and an `_optimize` among
  them, so the warmer and merge pools run beside the drainer) records lock
  traffic, no order cycle and no wait on the card under a held lock
  (`held_device_gets` 0);
- a wait under a held traced lock is counted, and the watchdog's next tick
  journals one `lock_stall` (`stall`);
- the port's `install()` refuses while another tracer (the JAX package's)
  has replaced the lock factories (`refuse`)."""

import json
import os
import subprocess
import sys
import threading

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.abspath(__file__)


def _run(mode, env_extra=None, timeout=240):
    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu"}
    env.pop("ESTPU_LOCKTRACE", None)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-m", "tests.test_torch_locktrace", mode],
                          capture_output=True, text=True, cwd=REPO, timeout=timeout,
                          env=env)


def _marked_lines():
    with open(HERE, encoding="utf-8") as f:
        marker = "# " + "ABBA"
        return [i for i, ln in enumerate(f.read().splitlines(), 1) if marker in ln]


def test_nothing_is_patched_with_the_knob_off():
    res = _run("knob")
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.splitlines()[-1]) == {
        "installed": False, "standard": True, "enabled": False}


def test_abba_fails_with_a_cycle_naming_both_sites():
    res = _run("abba", {"ESTPU_LOCKTRACE": "1"})
    assert res.returncode != 0
    assert "LockOrderViolation" in res.stderr and "lock-order cycle" in res.stderr
    lines = _marked_lines()
    assert len(lines) == 2
    for line_no in lines:
        assert f"test_torch_locktrace.py:{line_no}" in res.stderr, (line_no, res.stderr)


def test_abba_runs_clean_without_the_knob_and_fixed_order_passes_under_it():
    assert _run("abba").returncode == 0
    res = _run("fixed", {"ESTPU_LOCKTRACE": "1"})
    assert res.returncode == 0, res.stderr


def test_warmed_serving_loop_holds_no_lock_across_a_wait():
    res = _run("serve", {"ESTPU_LOCKTRACE": "1", "ESTPU_LOCKTRACE_HELD_MS": "250"},
               timeout=400)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    snap = json.loads(res.stdout.splitlines()[-1])
    assert snap["locks_created"] > 0 and snap["acquisitions"] > 0
    assert snap["edges"] >= 1
    assert snap["held_device_gets"] == 0 and snap["long_held"] == []
    assert snap["searches"] == 192 and snap["launches"] > 0
    assert snap["lock_stall"] == 0


def test_watchdog_journals_lock_stall_when_the_counters_grow():
    res = _run("stall", {"ESTPU_LOCKTRACE": "1", "ESTPU_LOCKTRACE_HELD_MS": "1"})
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    out = json.loads(res.stdout.splitlines()[-1])
    assert out["held_device_gets"] == 2
    assert out["long_held"] and out["long_held"][0][2] == "PendingPull.wait"
    assert out["long_held"][0][0].startswith("tests/test_torch_locktrace.py:")
    assert out["stalls"] == 1 and out["attrs"]["held_device_gets"] == 2
    assert out["after_quiet_tick"] == 1


def test_install_refuses_beside_another_tracer():
    res = _run("refuse")
    assert res.returncode == 0, res.stderr
    assert "another lock tracer" in res.stdout


# --- the subprocess modes ----------------------------------------------------


def _mode_knob():
    from elasticsearch_tpu_torch.common import locktrace

    installed = locktrace.maybe_install() is not None
    print(json.dumps({"installed": installed, "standard": locktrace._standard_factories(),
                      "enabled": locktrace.TRACER.enabled}))


def _mode_abba(fixed: bool):
    from elasticsearch_tpu_torch.common.locktrace import TRACER, maybe_install

    maybe_install()
    # one creation site is one lock class: the two locks on lines of their own
    a = threading.Lock()
    b = threading.Lock()

    def a_then_b():
        with a:
            with b:  # ABBA
                pass

    def b_then_a():
        with b:
            with a:  # ABBA
                pass

    for fn in (a_then_b, a_then_b if fixed else b_then_a):
        t = threading.Thread(target=fn)
        t.start()
        t.join()
    if TRACER.enabled:
        TRACER.check()


def _mode_serve():
    from elasticsearch_tpu_torch.common.locktrace import TRACER, maybe_install

    maybe_install()
    assert TRACER.enabled, "this mode needs ESTPU_LOCKTRACE=1"
    import tempfile
    import urllib.request

    import torch

    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.transport.local import LocalTransportRegistry

    torch.set_num_threads(1)

    def call(base, method, path, body=None, raw=None):
        data = raw.encode() if raw is not None else (
            None if body is None else json.dumps(body).encode())
        req = urllib.request.Request(base + path, data=data, method=method,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read())

    words = ["quick", "brown", "fox", "lazy", "dog", "summer", "red", "bear"]
    with tempfile.TemporaryDirectory() as td:
        node = Node(name="lt", settings={"node.device": "cpu", "watchdog.interval": "100ms",
                                         "search.batch.linger_ms": "2"},
                    registry=LocalTransportRegistry(), data_path=td).start()
        try:
            base = f"http://127.0.0.1:{node.start_http(0).port}"
            call(base, "PUT", "/a", {"settings": {"number_of_shards": 2,
                                                  "refresh_interval": -1}})
            lines = "".join(
                json.dumps({"index": {"_index": "a", "_type": "doc", "_id": str(i)}}) + "\n"
                + json.dumps({"body": f"{words[i % 8]} {words[(i + 1) % 8]} "
                                      f"{words[(i + 3) % 8]}"}) + "\n"
                for i in range(400))
            call(base, "POST", "/_bulk", raw=lines)
            call(base, "POST", "/a/_refresh")
            call(base, "POST", "/a/_search", {"query": {"match": {"body": "fox"}}})
            done = []

            def worker(k):
                for i in range(24):
                    body = {"query": {"match": {"body": f"{words[(k + i) % 8]} "
                                                        f"{words[(3 * k + i) % 8]}"}},
                            "request_cache": False}
                    r = call(base, "POST", "/a/_search", body)
                    assert r["_shards"]["failed"] == 0
                    done.append(1)
                    if k == 0 and i == 8:
                        call(base, "PUT", "/a/doc/new", {"body": "quick new"})
                        call(base, "POST", "/a/_refresh")
                        call(base, "POST", "/a/_optimize")

            threads = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
            node.watchdog.tick()
            stalls = sum(1 for e in node.events.events() if e["type"] == "lock_stall")
            launches = node.search_batcher.stats()["launches"]
        finally:
            node.close()
    TRACER.check()
    snap = TRACER.snapshot()
    print(json.dumps({**snap, "searches": len(done), "launches": launches,
                      "lock_stall": stalls}))


def _mode_stall():
    from elasticsearch_tpu_torch.common.locktrace import TRACER, maybe_install

    maybe_install()
    assert TRACER.enabled, "this mode needs ESTPU_LOCKTRACE=1"
    import time
    import types

    import torch

    from elasticsearch_tpu_torch.common import cudaenv
    from elasticsearch_tpu_torch.common.events import EventJournal, StallWatchdog
    from elasticsearch_tpu_torch.threadpool import ThreadPool

    pool = ThreadPool()
    node = types.SimpleNamespace(events=EventJournal(node_name="n", node_id="n"),
                                 threadpool=pool, search_batcher=None, breakers=None)
    dog = StallWatchdog(node)
    try:
        dog.tick()
        held = threading.Lock()
        pull = cudaenv.pull_async([torch.arange(4)])
        pull.wait()  # no lock held: not counted
        with held:
            time.sleep(0.002)
            slow = cudaenv.PendingPull(None, [torch.zeros(2)], types.SimpleNamespace(
                synchronize=lambda: time.sleep(0.01)))
            slow.wait()
            cudaenv.pull_async([torch.arange(2)]).wait()
        dog.tick()
        stalls = [e for e in node.events.events() if e["type"] == "lock_stall"]
        dog.tick()  # nothing grew: no second event
        after = sum(1 for e in node.events.events() if e["type"] == "lock_stall")
    finally:
        pool.shutdown()
    snap = TRACER.snapshot()
    print(json.dumps({"held_device_gets": snap["held_device_gets"],
                      "long_held": snap["long_held"], "stalls": len(stalls),
                      "attrs": stalls[0]["attrs"] if stalls else None,
                      "after_quiet_tick": after}))


def _mode_refuse():
    from elasticsearch_tpu.common import locktrace as jlocktrace
    from elasticsearch_tpu_torch.common import locktrace

    jlocktrace.install()
    try:
        locktrace.install()
    except RuntimeError as e:
        print(e)
        return
    raise AssertionError("the port's tracer installed beside the JAX one")


if __name__ == "__main__":
    mode = sys.argv[1]
    if mode == "knob":
        _mode_knob()
    elif mode in ("abba", "fixed"):
        _mode_abba(fixed=mode == "fixed")
    elif mode == "serve":
        _mode_serve()
    elif mode == "stall":
        _mode_stall()
    elif mode == "refuse":
        _mode_refuse()
    else:
        raise SystemExit(f"unknown mode {mode}")
