"""The port's TCP transport (transport/tcp.py): the cases of the JAX
package's tests/test_tcp_transport.py on the port's classes (framing,
correlation under concurrency, remote errors rebuilt as the port's own
classes, compression, a dead node, the response timer and a send-side
fault rule; its two-node cluster is
tests/test_torch_multinode_tcp.py's), and the frames themselves: every
frame a 2-node port cluster writes over real sockets while it forms,
creates an index, takes a seeded bulk, searches (query, fetch and free
context, DFS, count, aggregations), GETs, refreshes and leaves is byte for
byte the frame the JAX package's `tcp._encode` builds for the same
payload, compressed or not. So no tensor, pinned buffer or numpy value
reaches the codec: a shard's top-k crosses the wire as plain lists and
numbers."""

import json
import threading

import numpy as np
import pytest

from elasticsearch_tpu_torch.common.errors import (
    IndexMissingError,
    NodeNotConnectedError,
    ReceiveTimeoutError,
)
from elasticsearch_tpu_torch.transport.service import TransportService, fut_result
from elasticsearch_tpu_torch.transport.tcp import TcpTransport


@pytest.fixture()
def pair():
    a = TransportService(TcpTransport())
    b = TransportService(TcpTransport())
    yield a, b
    a.close()
    b.close()


def addr(service):
    return service.backend.address


def test_request_response_roundtrip(pair):
    a, b = pair
    b.register_handler("test/echo", lambda req, ch: {"echo": req["msg"], "n": req["n"] + 1})
    resp = a.submit_request(addr(b), "test/echo", {"msg": "hi", "n": 41}, timeout=10)
    assert resp == {"echo": "hi", "n": 42}


def test_concurrent_requests_correlate(pair):
    a, b = pair
    b.register_handler("test/id", lambda req, ch: {"v": req["v"] * 2})
    futs = [a.send_request(addr(b), "test/id", {"v": i}) for i in range(64)]
    for i, f in enumerate(futs):
        assert fut_result(f, 10)["v"] == 2 * i


def test_remote_error_reconstructed(pair):
    a, b = pair

    def boom(req, ch):
        raise IndexMissingError("nope")

    b.register_handler("test/boom", boom)
    with pytest.raises(IndexMissingError):
        a.submit_request(addr(b), "test/boom", {}, timeout=10)


def test_unknown_action_errors(pair):
    a, b = pair
    with pytest.raises(Exception) as ei:
        a.submit_request(addr(b), "test/missing", {}, timeout=10)
    assert "no handler" in str(ei.value)


def test_large_payload_and_compression():
    a = TransportService(TcpTransport(compress=True))
    b = TransportService(TcpTransport(compress=True))
    try:
        b.register_handler("test/big", lambda req, ch: {"size": len(req["blob"])})
        blob = "x" * (2 * 1024 * 1024)
        resp = a.submit_request(addr(b), "test/big", {"blob": blob}, timeout=30)
        assert resp["size"] == len(blob)
    finally:
        a.close()
        b.close()


def test_dead_node_raises_not_connected(pair):
    a, b = pair
    dead = addr(b)
    b.close()
    with pytest.raises((NodeNotConnectedError, ReceiveTimeoutError)):
        a.submit_request(dead, "test/echo", {}, timeout=5)


def test_handler_slow_response_timeout(pair):
    """A receive-side delay rule holds the handler past the request's
    timeout: ReceiveTimeoutError, and the late answer lands nowhere."""
    from elasticsearch_tpu_torch.transport.faults import FaultPolicy

    a, b = pair
    handled = threading.Event()

    def slow(req, ch):
        handled.set()
        return {"late": True}

    b.register_handler("test/slow", slow)
    FaultPolicy(seed=0).install(b)
    b.fault_policy.delay(1.0, action="test/slow", direction="recv")
    with pytest.raises(ReceiveTimeoutError):
        a.submit_request(addr(b), "test/slow", {}, timeout=0.2)
    assert handled.wait(5.0)


def test_fault_disconnect_rule_over_tcp(pair):
    """A send-side disconnect rule fails fast without touching the socket;
    past its one hit the path is healthy."""
    from elasticsearch_tpu_torch.transport.faults import FaultPolicy

    a, b = pair
    b.register_handler("test/echo", lambda req, ch: {"ok": True})
    policy = FaultPolicy(seed=0).install(a)
    rule = policy.disconnect(action="test/echo", max_hits=1)
    with pytest.raises(NodeNotConnectedError):
        a.submit_request(addr(b), "test/echo", {}, timeout=5)
    assert rule.hits == 1
    assert a.submit_request(addr(b), "test/echo", {}, timeout=5) == {"ok": True}


def test_response_timer_fails_a_lost_message(pair):
    """A dropped send resolves only by its timer (`send_request(timeout=)`),
    counted in the service's stats."""
    from elasticsearch_tpu_torch.transport.faults import FaultPolicy

    a, b = pair
    b.register_handler("test/echo", lambda req, ch: {"ok": True})
    FaultPolicy(seed=0).install(a).drop(action="test/echo", max_hits=1)
    fut = a.send_request(addr(b), "test/echo", {}, timeout=0.2)
    with pytest.raises(ReceiveTimeoutError):
        fut_result(fut, 5)
    assert a.stats["timed_out_count"] == 1 and a.stats["faults_injected"] == 1


# --------------------------------------------------------------------------
# the frames of a working cluster against the JAX package's encoder
# --------------------------------------------------------------------------

# the actions a 2-node cluster must have sent over the sockets
EXPECTED_ACTIONS = {
    "internal:discovery/zen/ping", "internal:discovery/zen/join",
    "internal:discovery/zen/publish", "internal:discovery/zen/leave",
    "internal:discovery/zen/fd/ping", "internal:cluster/shard/started",
    "indices:admin/create", "indices:data/write/bulk[s]",
    "indices:data/read/search[phase/query]", "indices:data/read/search[phase/fetch]",
    "indices:data/read/search[phase/dfs]", "indices:data/read/get[s]",
    "indices:admin/broadcast[s]", "cluster:client/exec",
}


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """(flags, payload, compress, port frame bytes) of every frame a 2-node
    port cluster over TCP writes (requests and responses)."""
    import torch

    import elasticsearch_tpu_torch.transport.tcp as ptcp
    from tests.test_torch_node import call
    from tests.test_torch_two_nodes import FD, Cluster

    recorded = []
    orig = ptcp._encode

    def recording(payload, flags, compress):
        raw = orig(payload, flags, compress)
        recorded.append((flags, payload, compress, raw))
        return raw

    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    ptcp._encode = recording
    c = None
    try:
        c = Cluster("port", ["a", "b"], tmp_path_factory.mktemp("frames"),
                    settings={**FD, "transport.tcp.compress": True}, transport="tcp")
        rng = np.random.default_rng(21)
        base_a, base_b = c.base("a"), c.base("b")
        st, r = call(base_b, "PUT", "/w", {"settings": {
            "number_of_shards": 4, "number_of_replicas": 0, "refresh_interval": -1}})
        assert st == 200, r
        assert c.settled("w")
        lines = []
        for i in range(200):
            lines += [json.dumps({"index": {"_index": "w", "_type": "doc", "_id": str(i)}}),
                      json.dumps({"body": " ".join(rng.choice(["x", "y", "z", "q", "r"],
                                                              int(rng.integers(1, 9)))),
                                  "n": int(rng.integers(0, 1000)) / 7.0})]
        assert call(base_a, "POST", "/_bulk", raw="\n".join(lines) + "\n")[0] == 200
        assert call(base_b, "POST", "/w/_refresh")[0] == 200
        for base in (base_a, base_b):
            assert call(base, "POST", "/w/_search", {
                "query": {"match": {"body": "x y"}}, "size": 30,
                "aggs": {"n": {"stats": {"field": "n"}}}})[0] == 200
            assert call(base, "POST", "/w/_search?search_type=dfs_query_then_fetch",
                        {"query": {"match": {"body": "z"}}})[0] == 200
            assert call(base, "POST", "/w/_count", {"query": {"match": {"body": "q"}}})[0] == 200
            for i in range(4):
                assert call(base, "GET", f"/w/doc/{i}")[0] == 200
        assert call(base_a, "GET", "/_cluster/stats")[0] == 200
        c.node("b").close()
        from tests.test_torch_two_nodes import wait_until

        assert wait_until(lambda: c.node("a").cluster_service.state.nodes.size == 1)
        yield recorded
    finally:
        ptcp._encode = orig
        torch.set_num_threads(saved)
        if c is not None:
            c.close()


def test_every_action_of_the_cluster_crossed_the_wire(frames):
    actions = {p["action"] for flags, p, _c, _raw in frames if not flags & 1}
    assert EXPECTED_ACTIONS <= actions, EXPECTED_ACTIONS - actions
    # with compression on, the frames from 1 KiB (published states) are zlib
    assert any(raw[2] & 4 for *_x, raw in frames)


def test_every_frame_is_the_jax_encoders(frames):
    from elasticsearch_tpu.transport.tcp import _encode as jax_encode

    by_action: dict = {}
    for flags, payload, compress, raw in frames:
        assert jax_encode(payload, flags, compress) == raw
        key = payload.get("action") if not flags & 1 else "<response>"
        by_action[key] = by_action.get(key, 0) + 1
    assert by_action["<response>"] > 0


def test_query_phase_answers_carry_plain_values(frames):
    """A query phase's answer: lists, numbers and strings only."""
    seen = 0

    def plain(v):
        if isinstance(v, dict):
            return all(isinstance(k, str) and plain(x) for k, x in v.items())
        if isinstance(v, (list, tuple)):
            return all(plain(x) for x in v)
        return v is None or type(v) in (bool, int, float, str, bytes)

    for flags, payload, _c, _raw in frames:
        body = payload.get("body")
        if flags & 1 and isinstance(body, dict) and "docs" in body and "ctx_id" in body:
            seen += 1
            assert plain(body), body
    assert seen >= 8
