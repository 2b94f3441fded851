"""The port's device fault domains (elasticsearch_tpu_torch/common/
devicehealth.py, transport/faults.py) against the JAX package's, on the CPU.

- Classification: every injected kind lands in the JAX kind's class in both
  packages; the CUDA taxonomy by code (transient, sticky, launch
  configuration, any other code, each from a kernel wrapper and from
  elsewhere), PyTorch's error classes and texts, and a plain RuntimeError
  that classifies None. A defect (a launch-configuration code, an
  unexpected code from a kernel wrapper) moves no circuit and reaches the
  caller; a node's start launches every kernel and stops on a defect.
- Circuits: both packages' `DeviceHealth`, driven with the same fake clock,
  the same seeded jitter and the same sequence of arms, go through the same
  transitions and stats; with every domain closed the serving path's gate
  takes no lock.
- `DeviceFaults`: glob, countdown and auto-disarm, as the JAX injector.
- Node against node (tests/test_devicehealth.py's chaos cases): a port node
  and a JAX node, each package's injector armed the same way — every
  response 200, hits bitwise equal to the other node's (both serve on the
  host scorer) and to the warmed baseline for the 2-term bodies of the JAX
  test (a 3-term TF-IDF sum may differ from the sparse path in the last
  place, in both packages: the sparse path's 2-ulp bar there), `_shards`
  equal, `degraded` included; the trip, the probe and the recovery; a
  poisoned batch member cannot fail or trip its neighbours; a failed warm
  pack is retried on its pool.
- The port's own domains: each dense family, the field sort and the
  aggregations degrade while their `compile:` domain is open, node against
  node: the same hits and `_shards` as the JAX node with the same domain
  open, and the card's answer at the family's bar; both recover.

The trackers and injectors are process-wide singletons of each package:
every test resets both packages' in a `finally` (the autouse fixture)."""

import random
import threading
import time

import pytest
import torch

from elasticsearch_tpu.common.devicehealth import DEVICE_HEALTH as J_HEALTH
from elasticsearch_tpu.common.devicehealth import DeviceHealth as JDeviceHealth
from elasticsearch_tpu.common.devicehealth import \
    classify_device_error as jclassify
from elasticsearch_tpu.transport.faults import DEVICE_FAULTS as J_FAULTS
from elasticsearch_tpu.transport.faults import DeviceFaults as JDeviceFaults
from elasticsearch_tpu.transport.faults import \
    make_device_error as jmake_device_error
from elasticsearch_tpu_torch.common import cudaenv
from elasticsearch_tpu_torch.common.cudaenv import CudaError, KernelBuildError
from elasticsearch_tpu_torch.common.devicehealth import (CLOSED, DEVICE_HEALTH,
                                                         OPEN, DeviceHealth,
                                                         classify_device_error,
                                                         tag_domain)
from elasticsearch_tpu_torch.node import KERNEL_START_CHECKS
from elasticsearch_tpu_torch.node import Node as PNode
from elasticsearch_tpu_torch.search import service as tservice
from elasticsearch_tpu_torch.search.service import SERVING_COUNTERS
from elasticsearch_tpu_torch.transport.faults import (DEVICE_ERROR_KINDS,
                                                      DEVICE_FAULTS, DeviceFaults,
                                                      make_device_error)
from elasticsearch_tpu_torch.transport.local import LocalTransportRegistry as PReg
from tests.test_torch_aggs import _agg_equal
from tests.test_torch_dense import _tie_tolerant_equal

VOCAB = ("alpha beta gamma delta epsilon zeta eta theta iota kappa lamda mu "
         "nu xi omicron pi rho sigma tau upsilon phi chi psi omega").split()
JAX_CLASS = {"oom": "transient", "timeout": "transient",
             "unavailable": "transient", "launch": "persistent",
             "transfer": "persistent", "internal": "persistent"}


def _reset_all():
    for faults in (DEVICE_FAULTS, J_FAULTS):
        faults.disarm()
    for health in (DEVICE_HEALTH, J_HEALTH):
        health.reset()


@pytest.fixture(autouse=True)
def _device_state_hygiene():
    """Both packages' trackers and injectors start and end every test
    closed and disarmed."""
    _reset_all()
    try:
        yield
    finally:
        _reset_all()


# ---------------------------------------------------------------------------
# classification
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", DEVICE_ERROR_KINDS)
def test_injected_kind_keeps_its_jax_class(kind):
    err = make_device_error(kind)
    assert classify_device_error(err) == jclassify(jmake_device_error(kind)) \
        == JAX_CLASS[kind]
    # CUDA-shaped: torch's out-of-memory class, else a CudaError with a code
    if kind == "oom":
        assert isinstance(err, torch.cuda.OutOfMemoryError)
    else:
        assert isinstance(err, CudaError) and err.code > 0
    assert make_device_error(kind) is not err  # fresh per injection


# (cudaError_t, class when PyTorch or an injector raised it, class when a
# kernel wrapper's launch returned it, sticky)
CODES = [(2, "transient", "transient", False), (46, "transient", "transient", False),
         (909, "transient", "transient", False),
         (700, "persistent", "persistent", True), (702, "persistent", "persistent", True),
         (710, "persistent", "persistent", True), (715, "persistent", "persistent", True),
         (716, "persistent", "persistent", True), (717, "persistent", "persistent", True),
         (718, "persistent", "persistent", True), (719, "persistent", "persistent", True),
         (9, "defect", "defect", False), (98, "defect", "defect", False),
         (209, "defect", "defect", False), (701, "defect", "defect", False),
         (1, "persistent", "defect", False), (999, "persistent", "defect", False)]


@pytest.mark.parametrize("code,cls,wrapper_cls,sticky", CODES, ids=[str(c[0]) for c in CODES])
def test_cuda_taxonomy_by_code(code, cls, wrapper_cls, sticky):
    err = CudaError(code, f"CUDA error {code}")
    assert err.sticky is sticky and err.kernel is None
    assert classify_device_error(err) == cls
    launched = CudaError(code, f"sparse_score launch failed: CUDA error {code}",
                         kernel="sparse_score")
    assert classify_device_error(launched) == wrapper_cls
    # PyTorch's own text for the same code classifies the same way
    text = cudaenv.ERROR_STRINGS.get(code)
    if text is not None:
        assert classify_device_error(RuntimeError(f"CUDA error: {text}")) == cls
        assert classify_device_error(torch.AcceleratorError(f"CUDA error: {text}")) == cls


def test_torch_error_classes_classify():
    assert classify_device_error(torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB")) == "transient"
    # a CUDA error PyTorch raised with no code the table knows: persistent
    assert classify_device_error(torch.AcceleratorError(
        "CUDA error: operation failed due to a previous error")) == "persistent"
    assert classify_device_error(RuntimeError(
        "CUDA driver error: unknown error")) == "persistent"
    # a torch op launched with a configuration the card refuses: a defect
    assert classify_device_error(torch.AcceleratorError(
        "CUDA error: too many resources requested for launch")) == "defect"


@pytest.mark.parametrize("code", [9, 98, 209, 701, 1])
def test_defect_moves_no_circuit(code):
    health = DeviceHealth()
    err = CudaError(code, f"sparse_score launch failed: CUDA error {code}",
                    kernel="sparse_score")
    assert health.record_failure("compile:sparse", err) == "defect"
    assert health.state("compile:sparse") == CLOSED
    assert not health.dirty and not health.any_open
    assert health.stats()["failures"] == {"transient": 0, "persistent": 0}


@pytest.mark.parametrize("err", [
    RuntimeError("boom"), RuntimeError("sparse_score: an illegal memory access"),
    ValueError("CUDA error: device-side assert triggered"), KeyError("x"),
    TimeoutError("deadline"), MemoryError()], ids=repr)
def test_host_errors_never_classify(err):
    """A host-side bug must not quarantine the card, whatever its text."""
    assert classify_device_error(err) is None
    health = DeviceHealth()
    assert health.record_failure("pull:i", err) is None
    assert health.state("pull:i") == CLOSED and not health.dirty


def test_tag_domain_first_tag_wins():
    e = make_device_error("oom")
    assert tag_domain(e, "pull:a") is e
    tag_domain(e, "pack:b")
    assert e._estpu_device_domain == "pull:a"


# ---------------------------------------------------------------------------
# circuits: the port's against the JAX package's, step by step
# ---------------------------------------------------------------------------

class _FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


# a scenario: ("fail", domain, kind) | ("host", domain) | ("ok", domains) |
# ("blocked", domains) | ("tick", seconds) | ("reset",)
SCENARIOS = {
    "transient_strikes": [("fail", "pull:i", "oom"), ("fail", "pull:i", "timeout"),
                          ("fail", "pull:i", "unavailable"), ("blocked", ("pull:i",))],
    "success_resets_strikes": [("fail", "pull:i", "oom"), ("fail", "pull:i", "oom"),
                               ("ok", ("pull:i",)), ("fail", "pull:i", "oom"),
                               ("blocked", ("pull:i",))],
    "persistent_trips": [("fail", "compile:sparse", "launch"),
                         ("blocked", ("pack:i", "compile:sparse", "pull:i"))],
    "host_error": [("host", "pull:i"), ("blocked", ("pull:i",)), ("ok", ("pull:i",))],
    "probe_and_recovery": [("fail", "pull:i", "transfer"), ("blocked", ("pull:i",)),
                           ("tick", 10.0), ("blocked", ("pull:i",)),
                           ("blocked", ("pull:i",)), ("ok", ("pull:i",)),
                           ("blocked", ("pull:i",))],
    "failed_probe_reopens": [("fail", "pull:i", "internal"), ("tick", 10.0),
                             ("blocked", ("pull:i",)), ("fail", "pull:i", "internal"),
                             ("blocked", ("pull:i",)), ("tick", 10.0),
                             ("blocked", ("pull:i",)), ("ok", ("pull:i",))],
    "open_straggler_success": [("fail", "pack:i", "launch"), ("ok", ("pack:i",)),
                               ("blocked", ("pack:i",))],
    "two_domains": [("fail", "pack:i", "launch"), ("fail", "pull:j", "oom"),
                    ("tick", 10.0), ("blocked", ("pull:j", "pack:i")),
                    ("ok", ("pack:i",)), ("reset",), ("blocked", ("pack:i",))],
}


def _drive(health_cls, make_error, steps):
    clock = _FakeClock()
    health = health_cls(base_s=0.05, cap_s=5.0, rng=random.Random(7), clock=clock)
    events = []
    health._publish = lambda type_, domain, *rest: events.append((type_, domain))
    trace = []
    for step in steps:
        op = step[0]
        if op == "fail":
            out = health.record_failure(step[1], make_error(step[2]))
        elif op == "host":
            out = health.record_failure(step[1], ValueError("host bug"))
        elif op == "ok":
            out = health.note_success(step[1])
        elif op == "blocked":
            out = health.blocked(step[1])
        elif op == "tick":
            clock.t += step[1]
            out = None
        else:
            out = health.reset()
        st = health.stats()
        for dom in st["domains"].values():
            dom.pop("last_error")  # each package's own error text
        trace.append((step, out, health.any_open, health.dirty, st))
    return trace, events


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_circuit_transitions_match_jax(name):
    got = _drive(DeviceHealth, make_device_error, SCENARIOS[name])
    want = _drive(JDeviceHealth, jmake_device_error, SCENARIOS[name])
    assert got == want


def test_probe_backoff_grows_within_bounds():
    trace, events = _drive(DeviceHealth, make_device_error,
                           SCENARIOS["failed_probe_reopens"])
    backoff_ms = trace[3][4]["domains"]["pull:i"]["backoff_ms"]
    assert 50.0 <= backoff_ms <= 5000.0
    assert trace[-1][4]["recoveries"] == 1 and trace[-1][4]["trips"] == 1
    assert events == [("device_degraded", "pull:i"), ("device_recovered", "pull:i")]


class _NoLock:
    def __enter__(self):
        raise AssertionError("the closed-world gate took the tracker's lock")

    def __exit__(self, *exc):
        return False


def test_closed_world_gate_is_lock_free_none(monkeypatch):
    """With every domain closed, the serving path's health checks are one
    attribute read each: no lock (and so no clock)."""
    from elasticsearch_tpu_torch.search.execute import _domain_seam

    monkeypatch.setattr(DEVICE_HEALTH, "_lock", _NoLock())
    monkeypatch.setattr(DEVICE_FAULTS, "_lock", _NoLock())

    class Ctx:
        index_name = "i"

    assert tservice._blocked_domain(Ctx(), ("sparse", "dense")) is None
    tservice._note_device_ok(Ctx(), ("sparse", "dense"))
    with _domain_seam("compile:sparse"):
        pass
    assert DEVICE_HEALTH.blocked(("pull:i", "compile:sparse")) is None


# ---------------------------------------------------------------------------
# DeviceFaults
# ---------------------------------------------------------------------------

def test_faults_glob_countdown_and_auto_disarm_match_jax():
    seen = []
    for faults, classify in ((DeviceFaults(), classify_device_error),
                             (JDeviceFaults(), jclassify)):
        faults.arm(error="oom", domain="pull:*", times=2)
        faults.check("pack:idx")  # no match: budget untouched
        out = []
        for domain in ("pull:idx", "pull:other", "pull:idx"):
            try:
                faults.check(domain)
                out.append(None)
            except Exception as e:  # noqa: BLE001 — the injected error
                out.append(classify(e))
        seen.append((out, faults.active, faults.injected))
    assert seen[0] == seen[1] == (["transient", "transient", None], False, 2)


def test_unknown_kind_rejected():
    with pytest.raises(ValueError):
        DeviceFaults().arm(error="gremlins")


def test_failed_pull_abandons_its_staging_without_a_cuda_call():
    """A failed wait drops the staging: no further wait, no event call."""
    from elasticsearch_tpu_torch.search.execute import wait_pull

    class Event:
        calls = 0

        def synchronize(self):
            Event.calls += 1
            raise RuntimeError("CUDA error: an illegal memory access was encountered")

    pull = cudaenv.PendingPull([torch.zeros(2)], [torch.zeros(2)], Event())
    with pytest.raises(RuntimeError) as ei:
        wait_pull(pull, "i")
    assert ei.value._estpu_device_domain == "pull:i"
    assert classify_device_error(ei.value) == "persistent"
    assert Event.calls == 1 and pull.wait() == []  # abandoned: nothing left
    DEVICE_FAULTS.arm("launch", "pull:j")
    pull = cudaenv.PendingPull(None, [torch.ones(3)], None)
    with pytest.raises(CudaError) as ei:
        wait_pull(pull, "j")
    assert ei.value.code == 719 and ei.value._estpu_device_domain == "pull:j"


# ---------------------------------------------------------------------------
# a shard context: breaker trips and the warmer's settings
# ---------------------------------------------------------------------------

def _lib_ctx(fielddata_limit=None, request_limit=None):
    from elasticsearch_tpu_torch.common.breaker import CircuitBreakerService
    from elasticsearch_tpu_torch.common.settings import Settings
    from elasticsearch_tpu_torch.index.engine import Searcher
    from elasticsearch_tpu_torch.index.segment import SegmentBuilder
    from elasticsearch_tpu_torch.mapper import MapperService
    from elasticsearch_tpu_torch.search import ShardContext, SimilarityService

    flat = {}
    if fielddata_limit is not None:
        flat["indices.fielddata.breaker.limit"] = fielddata_limit
    if request_limit is not None:
        flat["indices.breaker.request.limit"] = request_limit
    settings = Settings.from_flat(flat)
    svc = MapperService(settings)
    b = SegmentBuilder(0)
    rng = random.Random(3)
    for i in range(40):
        b.add(svc.mapper_for("doc").parse(
            {"body": " ".join(rng.choice(VOCAB[:8]) for _ in range(6))}, str(i)))
    return ShardContext(Searcher([b.freeze()]), svc, SimilarityService(settings, svc),
                        device="cpu", breakers=CircuitBreakerService(settings),
                        index_name="lib")


def test_fielddata_trip_while_packing_degrades_to_the_host_scorer():
    from elasticsearch_tpu_torch.search import execute_query_phase, parse_search_body

    ctx = _lib_ctx(fielddata_limit="1b")
    req = parse_search_body({"query": {"match": {"body": "alpha beta"}}})
    before = dict(SERVING_COUNTERS)
    res = execute_query_phase(ctx, req)
    host = execute_query_phase(ctx, req, use_device=False)
    assert res.degraded and (res.total, res.docs) == (host.total, host.docs)
    assert SERVING_COUNTERS["degraded"] - before["degraded"] == 1
    # a breaker trip is no CUDA error: no circuit moves
    assert not DEVICE_HEALTH.dirty and not DEVICE_HEALTH.any_open


def test_request_breaker_trip_stays_a_429(monkeypatch):
    from elasticsearch_tpu_torch.common.errors import CircuitBreakingError
    from elasticsearch_tpu_torch.search import execute_query_phase, parse_search_body

    ctx = _lib_ctx()

    def trip(*a, **k):
        e = CircuitBreakingError("[request] data too large")
        e.breaker = "request"
        raise e

    monkeypatch.setattr(tservice, "_execute_flat_single", trip)
    with pytest.raises(CircuitBreakingError):
        execute_query_phase(ctx, parse_search_body({"query": {"match": {"body": "alpha"}}}))
    assert not DEVICE_HEALTH.dirty


@pytest.mark.parametrize("code", [9, 98, 209, 701, 1])
def test_kernel_defect_raises_and_moves_no_circuit(monkeypatch, code):
    """A launch the card refuses as configured, or a code no launch should
    return, is a fault of the program: the search raises (a 500) instead of
    moving its tensors' work to the host, and no circuit moves."""
    from elasticsearch_tpu_torch.search import execute_query_phase, parse_search_body

    ctx = _lib_ctx()

    def refuse(*a, **k):
        raise CudaError(code, f"sparse_score launch failed: CUDA error {code}",
                        kernel="sparse_score")

    monkeypatch.setattr(tservice, "_execute_flat_single", refuse)
    before = dict(SERVING_COUNTERS)
    with pytest.raises(CudaError):
        execute_query_phase(ctx, parse_search_body({"query": {"match": {"body": "alpha"}}}))
    assert SERVING_COUNTERS["device_errors"] - before["device_errors"] == 1
    assert SERVING_COUNTERS["degraded"] == before["degraded"]
    assert not DEVICE_HEALTH.dirty and not DEVICE_HEALTH.any_open


def test_sticky_code_from_a_wrapper_degrades(monkeypatch):
    """A kernel wrapper that meets a context lost by earlier work returns
    the sticky code: that is a failure of the card, and the host answers."""
    from elasticsearch_tpu_torch.search import execute_query_phase, parse_search_body

    ctx = _lib_ctx()
    req = parse_search_body({"query": {"match": {"body": "alpha beta"}}})
    host = execute_query_phase(ctx, req, use_device=False)

    def lost(*a, **k):
        raise CudaError(710, "sparse_score launch failed: CUDA error 710",
                        kernel="sparse_score")

    monkeypatch.setattr(tservice, "_execute_flat_single", lost)
    res = execute_query_phase(ctx, req)
    assert res.degraded and (res.total, res.docs) == (host.total, host.docs)
    assert DEVICE_HEALTH.state("pull:lib") == OPEN


def test_warmer_reads_its_retry_settings():
    from elasticsearch_tpu_torch.common.settings import Settings
    from elasticsearch_tpu_torch.warmer import IndexWarmerService

    w = IndexWarmerService(Settings.from_flat({}), torch.device("cpu"), None)
    assert w.pack_retry_budget == 2 and w._retry_policy.base_s == 0.05
    w = IndexWarmerService(Settings.from_flat({
        "indices.warmer.pack_retries": "5", "indices.warmer.pack_retry_base": "0.01"}),
        torch.device("cpu"), None)
    assert w.pack_retry_budget == 5 and w._retry_policy.base_s == 0.01
    assert w.stats()["pack_retries"] == 0


# ---------------------------------------------------------------------------
# node start builds the kernels
# ---------------------------------------------------------------------------

def test_node_start_builds_and_loads_every_kernel_on_a_cuda_device(tmp_path, monkeypatch):
    """Built, loaded and launched once by its start check, each kernel in
    turn, before the node elects itself."""
    calls = []
    monkeypatch.setattr(cudaenv, "build_all", lambda: calls.append("build") or
                        {"sparse_score": "ptxas info"})
    monkeypatch.setattr(cudaenv, "load_library", lambda name: calls.append(name))
    for name in cudaenv.kernel_sources():
        monkeypatch.setitem(KERNEL_START_CHECKS, name,
                            lambda device, name=name: calls.append(("check", name, str(device))))
    node = PNode(name="b", settings={"node.device": "cpu"}, registry=PReg(),
                 data_path=str(tmp_path / "b"))
    try:
        node.device = torch.device("cuda", 0)  # what a node on the card holds
        node.start()
        want = ["build"]
        for name in cudaenv.kernel_sources():
            want += [name, ("check", name, "cuda:0")]
        assert calls == want
        assert node.kernel_builds == {"sparse_score": "ptxas info"}
        health = node.device_health()
        assert health["health"]["any_open"] is False
        assert health["warmer"]["pack_retries"] == 0
    finally:
        node.close()


def test_kernel_build_error_stops_the_start(tmp_path, monkeypatch):
    def refuse():
        raise KernelBuildError("sparse_score: nvcc exited 1")

    monkeypatch.setattr(cudaenv, "build_all", refuse)
    node = PNode(name="c", settings={"node.device": "cpu"}, registry=PReg(),
                 data_path=str(tmp_path / "c"))
    node.device = torch.device("cuda", 0)
    with pytest.raises(KernelBuildError):
        node.start()
    assert node._closed  # its pools are shut down with the failed start


def _refused_launch(code):
    def check(device):
        raise CudaError(code, f"sparse_score launch failed: CUDA error {code}",
                        kernel="sparse_score")
    return check


def _disagreeing(device):
    raise KernelBuildError("sparse_score: the start check's scores disagree")


@pytest.mark.parametrize("check", [_refused_launch(209), _refused_launch(98),
                                   _refused_launch(701), _disagreeing],
                         ids=["no_image_209", "device_function_98", "resources_701",
                              "disagrees"])
def test_kernel_start_check_failure_stops_the_start(tmp_path, monkeypatch, check):
    """A kernel that builds but cannot launch on the card, or disagrees with
    its plain version, stops the start: the node never serves past it."""
    monkeypatch.setattr(cudaenv, "build_all", lambda: {})
    monkeypatch.setattr(cudaenv, "load_library", lambda name: None)
    monkeypatch.setitem(KERNEL_START_CHECKS, "sparse_score", check)
    node = PNode(name="c", settings={"node.device": "cpu"}, registry=PReg(),
                 data_path=str(tmp_path / "c"))
    node.device = torch.device("cuda", 0)
    with pytest.raises((KernelBuildError, CudaError)):
        node.start()
    assert node._closed


def test_every_kernel_has_a_start_check_covering_its_variants():
    from elasticsearch_tpu_torch.ops.sparse_kernels import _launch_plan, start_check

    assert sorted(KERNEL_START_CHECKS) == cudaenv.kernel_sources()
    # on the CPU the check holds the plain version against itself: both
    # variants' shapes, each in the simple and the bool mode
    assert start_check(torch.device("cpu")) == 4
    assert {_launch_plan(2, tb, True).variant for tb in (8, 128)} == {"smem", "global"}


# ---------------------------------------------------------------------------
# node against node
# ---------------------------------------------------------------------------

IDX_PIN, IDX_SPLIT, IDX_PACK, IDX_FAM = "dpin", "dsplit", "dpack", "dfam"
FAM_SHARDS = 2
FAM_MAPPING = {"doc": {"properties": {
    "body": {"type": "string"}, "cat": {"type": "string", "index": "not_analyzed"},
    "pop": {"type": "integer"}, "likes": {"type": "integer"}}}}


def _fill(client, with_family: bool = True):
    rng = random.Random(18)
    for name, shards, docs, extra in (
            (IDX_PIN, 1, 80, {}), (IDX_SPLIT, 1, 60, {}),
            (IDX_PACK, 1, 50, {"index.refresh_interval": -1})):
        client.create_index(name, {"settings": {
            "number_of_shards": shards, "number_of_replicas": 0, **extra}})
        client.cluster_health(wait_for_status="green")
        for i in range(docs):
            body = " ".join(rng.choice(VOCAB) for _ in range(rng.randint(5, 20)))
            client.index(name, "doc", {"body": body, "n": i}, id=str(i))
        client.refresh(name)
    if with_family:
        client.create_index(IDX_FAM, {"settings": {
            "number_of_shards": FAM_SHARDS, "number_of_replicas": 0,
            "index.refresh_interval": -1}, "mappings": FAM_MAPPING})
        client.cluster_health(wait_for_status="green")
        for i in range(120):
            src = {"body": " ".join(rng.choice(VOCAB[:10]) for _ in range(rng.randint(3, 12))),
                   "likes": rng.randint(0, 100), "cat": f"c{rng.randint(0, 4)}"}
            if i % 7:
                src["pop"] = rng.randint(1, 50)
            client.index(IDX_FAM, "doc", src, id=str(i))
        client.refresh(IDX_FAM)


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    """(port node, port client, JAX node, JAX client), both with a 20 ms
    linger so concurrent searches coalesce; the JAX node's mesh off (its
    1-shard indexes would not ride it anyway)."""
    from elasticsearch_tpu.node import Node as JNode
    from elasticsearch_tpu.transport.local import LocalTransportRegistry as JReg

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    p = PNode(name="port_dh", registry=PReg(),
              settings={"node.device": "cpu", "search.batch.linger_ms": 20.0},
              data_path=str(tmp_path_factory.mktemp("port_dh"))).start()
    j = JNode(name="jax_dh", registry=JReg(),
              settings={"search.batch.linger_ms": 20.0, "search.mesh.enabled": "false"},
              data_path=str(tmp_path_factory.mktemp("jax_dh")))
    try:
        j.start([j.local_node.transport_address])
        j.wait_for_master()
        pc, jc = p.client(), j.client()
        _fill(pc, with_family=True)
        _fill(jc, with_family=True)
        yield p, pc, j, jc
    finally:
        _reset_all()
        p.close()
        j.close()
        torch.set_num_threads(threads)


def _hits(r):
    return [(h["_id"], h["_score"]) for h in r["hits"]["hits"]]


def _wait(pred, timeout=15.0, interval=0.02, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {what}")


def test_degrade_never_500_then_probed_recovery_matches_jax(nodes):
    """A persistent `pull:` fault armed the same way on both nodes: the
    first failing search trips the domain and already answers degraded;
    concurrent searches stay 200 with the warmed hits; both nodes' `_shards`
    and hits agree; disarming recovers through the half-open probe."""
    p, pc, j, jc = nodes
    domain = f"pull:{IDX_PIN}"
    queries = [{"query": {"match": {"body": f"{a} {b}"}}, "size": 10}
               for a, b in zip(VOCAB[:6], VOCAB[8:14])]
    baseline = [_hits(pc.search(IDX_PIN, q)) for q in queries]
    assert baseline == [_hits(jc.search(IDX_PIN, q)) for q in queries]
    deg0 = SERVING_COUNTERS["degraded"]
    for faults in (DEVICE_FAULTS, J_FAULTS):
        faults.arm(error="transfer", domain=domain, times=1_000_000)
    try:
        for i, q in enumerate(queries):
            pr, jr = pc.search(IDX_PIN, q), jc.search(IDX_PIN, q)
            assert _hits(pr) == _hits(jr) == baseline[i]  # bitwise: the host scorer
            assert pr["_shards"] == jr["_shards"] == {
                "total": 1, "successful": 1, "degraded": 1, "failed": 0}
        for health in (DEVICE_HEALTH, J_HEALTH):
            # one trip; a half-open probe admitted between two searches
            # (on a slow host) fails again and counts, trips nothing more
            st = health.stats()
            assert health.state(domain) == OPEN and st["trips"] == 1
            assert st["failures"]["transient"] == 0 and st["failures"]["persistent"] >= 1
        errors = []

        def chaos_loop():
            try:
                for i in range(12):
                    r = pc.search(IDX_PIN, queries[i % len(queries)])
                    assert _hits(r) == baseline[i % len(queries)]
                    assert r["_shards"]["degraded"] == 1
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        threads = [threading.Thread(target=chaos_loop) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors[:1]
        assert SERVING_COUNTERS["degraded"] - deg0 >= len(queries) + 36
    finally:
        for faults in (DEVICE_FAULTS, J_FAULTS):
            faults.disarm()
    for client, health in ((pc, DEVICE_HEALTH), (jc, J_HEALTH)):
        _wait(lambda: (client.search(IDX_PIN, queries[0]),
                       health.state(domain) == CLOSED)[1], what=f"{domain} recovery")
        st = health.stats()
        assert st["probes"] >= 1 and st["recoveries"] >= 1 and not health.any_open
    pr, jr = pc.search(IDX_PIN, queries[0]), jc.search(IDX_PIN, queries[0])
    assert _hits(pr) == _hits(jr) == baseline[0]
    assert pr["_shards"] == jr["_shards"] == {
        "total": 1, "successful": 1, "degraded": 0, "failed": 0}


@pytest.mark.parametrize("kind,domain", [("launch", "compile:sparse"),
                                         ("internal", "pull:*")])
def test_sparse_family_degrade_matches_jax(nodes, kind, domain):
    p, pc, j, jc = nodes
    q = {"query": {"match": {"body": "gamma delta epsilon"}}, "size": 15}
    base = pc.search(IDX_SPLIT, q)
    assert _hits(base) == _hits(jc.search(IDX_SPLIT, q))
    for faults in (DEVICE_FAULTS, J_FAULTS):
        faults.arm(error=kind, domain=domain, times=1_000)
    try:
        for _ in range(3):
            pr, jr = pc.search(IDX_SPLIT, q), jc.search(IDX_SPLIT, q)
            # both host scorers: bitwise; against the device's answer, the
            # sparse path's bar (a 3-term TF-IDF sum may round differently
            # in the last place, in the JAX package as in the port)
            assert _hits(pr) == _hits(jr)
            assert _tie_tolerant_equal([(s, d) for d, s in _hits(pr)],
                                       [(s, d) for d, s in _hits(base)])
            assert pr["_shards"] == jr["_shards"] and pr["_shards"]["degraded"] == 1
        tripped = "compile:sparse" if domain == "compile:sparse" else f"pull:{IDX_SPLIT}"
        assert DEVICE_HEALTH.state(tripped) == J_HEALTH.state(tripped) == OPEN
        for health in (DEVICE_HEALTH, J_HEALTH):
            failures = health.stats()["failures"]
            assert failures["transient"] == 0 and failures["persistent"] >= 1
    finally:
        for faults in (DEVICE_FAULTS, J_FAULTS):
            faults.disarm()
    _wait(lambda: (pc.search(IDX_SPLIT, q), not DEVICE_HEALTH.any_open)[1],
          what="port recovery")
    assert pc.search(IDX_SPLIT, q)["_shards"]["degraded"] == 0


def test_one_poisoned_plan_cannot_fail_or_trip_neighbors(nodes):
    """Two transient faults in a coalesced batch: the batch is split and its
    members replayed, so at most the two injected hits degrade, neighbours
    are served by the device and the circuit stays closed — on both nodes."""
    p, pc, j, jc = nodes
    body = {"query": {"match": {"body": "alpha beta"}}, "size": 5}
    for node, client, faults, health in ((p, pc, DEVICE_FAULTS, DEVICE_HEALTH),
                                         (j, jc, J_FAULTS, J_HEALTH)):
        bat = node.search_batcher
        expected = _hits(client.search(IDX_SPLIT, body))
        results, errors = [], []
        splits0 = bat.stats()["device_splits"]
        faults.arm(error="oom", domain=f"pull:{IDX_SPLIT}", times=2)
        barrier = threading.Barrier(6)

        def worker():
            barrier.wait()
            try:
                results.append(client.search(IDX_SPLIT, body))
            except Exception as e:  # noqa: BLE001 — asserted below
                errors.append(e)

        threads = [threading.Thread(target=worker) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors[:1]
        assert [_hits(r) for r in results] == [expected] * 6
        deg = sum(r["_shards"]["degraded"] for r in results)
        assert deg <= 2, deg
        assert not faults.active  # both injections consumed
        assert health.state(f"pull:{IDX_SPLIT}") == CLOSED and not health.any_open
        assert bat.stats()["device_splits"] > splits0 or deg >= 1
        faults.disarm()
        health.reset()


def test_kernel_defect_on_the_node_raises_and_the_next_search_is_served(nodes, monkeypatch):
    """A defect through the node's batcher and transport: the search fails
    with the wrapper's CudaError (a 500 over REST), nothing degrades, no
    circuit moves, and the next search is served on the device."""
    p, pc, j, jc = nodes
    q = {"query": {"match": {"body": "alpha gamma"}}, "size": 5}
    want = _hits(pc.search(IDX_SPLIT, q))
    before = dict(SERVING_COUNTERS)
    orig = tservice._execute_flat_single

    def refused(*a, **k):
        raise CudaError(209, "sparse_score launch failed: CUDA error 209: no kernel "
                        "image is available for execution on the device",
                        kernel="sparse_score")

    monkeypatch.setattr(tservice, "_execute_flat_single", refused)
    with pytest.raises(Exception, match="CUDA error 209"):
        pc.search(IDX_SPLIT, q)
    monkeypatch.setattr(tservice, "_execute_flat_single", orig)
    assert SERVING_COUNTERS["device_errors"] - before["device_errors"] == 1
    assert SERVING_COUNTERS["degraded"] == before["degraded"]
    assert not DEVICE_HEALTH.dirty and not DEVICE_HEALTH.any_open
    r = pc.search(IDX_SPLIT, q)
    assert _hits(r) == want and r["_shards"]["degraded"] == 0


def test_transient_pack_failure_retries_on_pool(nodes):
    p, pc, j, jc = nodes
    q = {"query": {"match": {"body": "gamma"}}, "size": 5}
    for node, client, faults, health in ((p, pc, DEVICE_FAULTS, DEVICE_HEALTH),
                                         (j, jc, J_FAULTS, J_HEALTH)):
        w = node.warmer
        client.search(IDX_PACK, q)  # opens the warm gate
        retries0, fails0, done0 = w.pack_retries, w.pack_failures, w.packs_done
        faults.arm(error="oom", domain=f"pack:{IDX_PACK}", times=1)
        client.index(IDX_PACK, "doc", {"body": "gamma gamma delta", "n": 900}, id="900")
        client.refresh(IDX_PACK)
        _wait(lambda: w.pack_retries > retries0 and w.packs_done > done0,
              what="warmer pack retry")
        assert w.pack_failures == fails0  # the retry healed it
        assert health.state(f"pack:{IDX_PACK}") == CLOSED
        r = client.search(IDX_PACK, q)
        assert r["_shards"]["degraded"] == 0
        assert any(h["_id"] == "900" for h in r["hits"]["hits"])
    assert p.warmer.stats()["pack_retries"] == p.warmer.pack_retries


def test_persistent_pack_failure_trips_then_degrades_then_recovers(nodes):
    p, pc, j, jc = nodes
    domain = f"pack:{IDX_PACK}"
    q = {"query": {"match": {"body": "delta"}}, "size": 10}
    answers = []
    for node, client, faults, health in ((p, pc, DEVICE_FAULTS, DEVICE_HEALTH),
                                         (j, jc, J_FAULTS, J_HEALTH)):
        w = node.warmer
        client.search(IDX_PACK, q)  # gate open, steady state packed
        fails0, retries0 = w.pack_failures, w.pack_retries
        faults.arm(error="launch", domain=domain, times=1_000)
        client.index(IDX_PACK, "doc", {"body": "delta delta zeta", "n": 901}, id="901")
        client.refresh(IDX_PACK)
        # initial + pack_retries attempts, then the final failure trips
        _wait(lambda: w.pack_failures > fails0, what="warmer final failure")
        assert w.pack_retries - retries0 == 2
        assert health.state(domain) == OPEN
        r = client.search(IDX_PACK, q)
        assert any(h["_id"] == "901" for h in r["hits"]["hits"])
        assert r["_shards"]["failed"] == 0 and r["_shards"]["degraded"] == 1
        answers.append(r)
        faults.disarm()
        _wait(lambda: (client.search(IDX_PACK, q), health.state(domain) == CLOSED)[1],
              what=f"{domain} probe recovery")
        r = client.search(IDX_PACK, q)
        assert r["_shards"]["degraded"] == 0
        assert any(h["_id"] == "901" for h in r["hits"]["hits"])
    assert _hits(answers[0]) == _hits(answers[1])
    assert answers[0]["_shards"] == answers[1]["_shards"]


# the port's own domains: (body, the domain to arm, the serving counter the
# device branch moves, the bar)
FAMILY_CASES = {
    "filtered": ({"query": {"filtered": {"query": {"match": {"body": "alpha beta"}},
                                         "filter": {"range": {"pop": {"gte": 20}}}}},
                  "size": 10}, "compile:filtered", "device_filtered", "dense"),
    "post_filter": ({"query": {"match": {"body": "alpha gamma"}},
                     "post_filter": {"term": {"cat": "c1"}}, "size": 10},
                    "compile:filtered", "device_filtered", "dense"),
    "function_score": ({"query": {"function_score": {
        "query": {"match": {"body": "beta delta"}},
        "functions": [{"field_value_factor": {"field": "likes", "modifier": "log1p",
                                              "missing": 1}}],
        "boost_mode": "sum"}}, "size": 10},
        "compile:function_score", "device_function_score", "dense"),
    "min_score": ({"query": {"match": {"body": "beta gamma"}}, "min_score": 0.2,
                   "size": 10}, "compile:function_score", "device_filtered", "dense"),
    "sort": ({"query": {"match": {"body": "alpha delta"}}, "sort": [{"pop": "asc"}],
              "size": 12}, "compile:sorted", "device_sort", "sort"),
    "aggs": ({"query": {"match": {"body": "epsilon"}}, "size": 0, "aggs": {
        "s": {"stats": {"field": "likes"}}, "t": {"terms": {"field": "cat"}}}},
        "compile:aggs", "device_aggs", "aggs"),
    "post_filter_aggs": ({"query": {"match": {"body": "alpha"}}, "size": 10,
                          "post_filter": {"term": {"cat": "c2"}},
                          "aggs": {"t": {"terms": {"field": "cat"}}}},
                         "compile:aggs", "device_filtered", "aggs"),
}


def _at_bar(got, want, bar):
    assert got["hits"]["total"] == want["hits"]["total"]
    if bar == "sort":
        assert [(h["_id"], h["sort"]) for h in got["hits"]["hits"]] == \
            [(h["_id"], h["sort"]) for h in want["hits"]["hits"]]
        return
    assert _tie_tolerant_equal([(h["_score"], h["_id"]) for h in got["hits"]["hits"]],
                               [(h["_score"], h["_id"]) for h in want["hits"]["hits"]])
    if bar == "aggs":
        _agg_equal(got["aggregations"], want["aggregations"])


def _same_degraded_answer(pr, jr, bar):
    """Both nodes served the body on their host paths: the same hits, sort
    values and aggregations."""
    assert pr["hits"]["total"] == jr["hits"]["total"]
    assert _hits(pr) == _hits(jr)
    if bar == "sort":
        assert [h["sort"] for h in pr["hits"]["hits"]] == [h["sort"] for h in jr["hits"]["hits"]]
    if bar == "aggs":
        _agg_equal(pr["aggregations"], jr["aggregations"])


@pytest.mark.parametrize("case", list(FAMILY_CASES))
def test_device_family_degrades_at_its_bar_and_recovers(nodes, case):
    """The family's `compile:` domain open on both nodes: the port's
    injector armed at the seam (the first search trips it), the JAX
    tracker given the same persistent error against the same domain (the
    JAX package launches these families behind its `compile:sparse` and
    `compile:dense` seams, so an injector armed at this name never fires
    there). With both trackers' clocks held, so that no probe is admitted,
    the nodes answer alike: the same hits and `_shards`, `degraded`
    included; the port's answer is the card's at the family's bar, and its
    family launches nothing. Disarmed, both recover. Both nodes' request
    caches are bypassed: they would answer the `size: 0` body without a
    search."""
    p, pc, j, jc = nodes
    body, domain, counter, bar = FAMILY_CASES[case]
    body = jbody = {**body, "request_cache": False}
    before = SERVING_COUNTERS[counter]
    base = pc.search(IDX_FAM, body)
    assert SERVING_COUNTERS[counter] - before == FAM_SHARDS  # the card's branch
    assert base["_shards"]["degraded"] == 0 and base["hits"]["total"] > 0
    assert jc.search(IDX_FAM, jbody)["_shards"] == base["_shards"]
    clocks = [(h, h._clock) for h in (DEVICE_HEALTH, J_HEALTH)]
    frozen = time.monotonic()
    for health, _clock in clocks:
        health._clock = lambda: frozen
    DEVICE_FAULTS.arm(error="launch", domain=domain, times=1_000)
    J_HEALTH.record_failure(domain, jmake_device_error("launch"))
    try:
        r = pc.search(IDX_FAM, body)  # each shard's launch fails: both trip
        assert r["_shards"] == {"total": FAM_SHARDS, "successful": FAM_SHARDS,
                                "degraded": FAM_SHARDS, "failed": 0}
        _at_bar(r, base, bar)
        assert DEVICE_HEALTH.state(domain) == J_HEALTH.state(domain) == OPEN
        injected, moved = DEVICE_FAULTS.injected, SERVING_COUNTERS[counter]
        pr, jr = pc.search(IDX_FAM, body), jc.search(IDX_FAM, jbody)
        assert pr["_shards"] == jr["_shards"] == r["_shards"]
        _same_degraded_answer(pr, jr, bar)
        _same_degraded_answer(pr, r, bar)
        _at_bar(pr, base, bar)
        # open, no probe due: no launch reached the seam
        assert DEVICE_FAULTS.injected == injected and SERVING_COUNTERS[counter] == moved
        # a family the domain does not gate still runs on the device
        plain = SERVING_COUNTERS["device_sparse"]
        zeta = {"query": {"match": {"body": "zeta"}}}
        pz, jz = pc.search(IDX_FAM, zeta), jc.search(IDX_FAM, zeta)
        assert pz["_shards"]["degraded"] == jz["_shards"]["degraded"] == 0
        assert SERVING_COUNTERS["device_sparse"] - plain == FAM_SHARDS
    finally:
        DEVICE_FAULTS.disarm()
        for health, clock in clocks:
            health._clock = clock
    for client, health, b in ((pc, DEVICE_HEALTH, body), (jc, J_HEALTH, jbody)):
        _wait(lambda: (client.search(IDX_FAM, b), not health.any_open)[1],
              what=f"{domain} recovery")
    moved = SERVING_COUNTERS[counter]
    r, jr = pc.search(IDX_FAM, body), jc.search(IDX_FAM, jbody)
    assert r["_shards"] == jr["_shards"] == base["_shards"]
    assert SERVING_COUNTERS[counter] - moved == FAM_SHARDS
    _at_bar(r, base, bar)
