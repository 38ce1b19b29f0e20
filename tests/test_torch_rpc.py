"""The port's control-plane rpc against the reference's
(``tests/test_rpc_misc.py``, ``tests/test_partition_tolerance.py``):
``RpcEndpoint`` over the native ``TCPStore`` and over a ``LeaseStore``,
typed errors crossing the wire with their fields, at-least-once delivery
under a seeded drop plan with exactly-once handler effects, the untraced
and traced envelopes, and ``init_rpc`` / ``rpc_sync`` / ``rpc_async``.
Every case runs on both packages (``pkg``); one pair of endpoints a
package serves the module (an endpoint's ``stop`` takes seconds). The
subprocess cluster tests drive rpc between processes.
"""

import json
import os
import pickle
import threading

import pytest
import torch

from paddle_tpu.distributed import net_store as jax_net_store
from paddle_tpu.distributed import rpc as jax_rpc
from paddle_tpu.distributed import watchdog as jax_watchdog
from paddle_tpu.inference import cluster as jax_cluster
from paddle_tpu.inference import serving as jax_serving
from paddle_tpu.observability import metrics as jax_om
from paddle_tpu.observability import tracing as jax_tracing
from paddle_tpu.testing import faults as jax_faults

from paddle_tpu_torch.distributed import net_store, rpc, watchdog
from paddle_tpu_torch.inference import cluster, serving
from paddle_tpu_torch.observability import metrics as om
from paddle_tpu_torch.observability import tracing
from paddle_tpu_torch.testing import faults

# One intra-op thread a process (the suite runs in xdist workers).
torch.set_num_threads(1)


class Pkg:
    def __init__(self, name, rpc_mod, ns, wd, cl, sv, om_mod, tr, fa):
        self.name = name
        self.rpc, self.om, self.tracing, self.faults = rpc_mod, om_mod, \
            tr, fa
        self.LeaseStore, self.LeaseStoreServer = ns.LeaseStore, \
            ns.LeaseStoreServer
        self.StaleEpochError = wd.StaleEpochError
        self.ReplicaLostError = cl.ReplicaLostError
        self.AdmissionError = sv.AdmissionError
        self.DeadlineExceeded = sv.DeadlineExceeded


PKGS = {"reference": Pkg("reference", jax_rpc, jax_net_store, jax_watchdog,
                         jax_cluster, jax_serving, jax_om, jax_tracing,
                         jax_faults),
        "port": Pkg("port", rpc, net_store, watchdog, cluster, serving, om,
                    tracing, faults)}


@pytest.fixture(scope="module", params=["reference", "port"])
def pkg(request):
    return PKGS[request.param]


@pytest.fixture(autouse=True)
def _clean_faults():
    for p in PKGS.values():
        p.faults.reset()
    yield
    os.environ.pop(faults.PLAN_ENV, None)
    for p in PKGS.values():
        p.faults.reset()


def _plan(rules):
    os.environ[faults.PLAN_ENV] = json.dumps(rules)
    for p in PKGS.values():
        p.faults.reset()


# handlers: module level, so they pickle by reference
_CALLS = []
_CALLS_LOCK = threading.Lock()


def double(x):
    return 2 * x


def record(x):
    with _CALLS_LOCK:
        _CALLS.append(x)
    return x + 1


def raise_typed(pkg_name, which):
    p = PKGS[pkg_name]
    raise {"admission": p.AdmissionError(
               "full", live=2, max_batch=2, free_pages=0, num_pages=48,
               retries=1, retry_after=0.25),
           "deadline": p.DeadlineExceeded(
               "late", seq_id=3, elapsed=1.5, tokens_emitted=4,
               reason="deadline"),
           "stale": p.StaleEpochError("replica-0", 1, 2),
           "lost": p.ReplicaLostError("gone", replica_id="replica-1",
                                      failovers=3),
           "value": ValueError("bad prompt")}[which]


@pytest.fixture(scope="module")
def endpoints(pkg):
    router = pkg.rpc.RpcEndpoint("router", is_master=True, port=0)
    worker = pkg.rpc.RpcEndpoint("w1", host=router.host, port=router.port)
    yield router, worker
    worker.stop()
    router.stop()


def test_calls_both_ways(pkg, endpoints):
    router, worker = endpoints
    assert router.call_sync("w1", double, (21,), timeout=10.0) == 42
    assert worker.call_sync("router", double, (4,), timeout=10.0) == 8
    fut = router.call("w1", double, (5,), timeout=10.0)
    assert fut.wait(10.0) == 10


@pytest.mark.parametrize("which", ["admission", "deadline", "stale", "lost",
                                   "value"])
def test_typed_errors_cross_with_their_fields(pkg, endpoints, which):
    router, _ = endpoints
    with pytest.raises(Exception) as ei:
        router.call_sync("w1", raise_typed, (pkg.name, which), timeout=10.0)
    e = ei.value
    try:
        raise_typed(pkg.name, which)
    except Exception as local:
        want = local
    assert type(e) is type(want) and str(e) == str(want)
    assert vars(e) == vars(want)
    back = pickle.loads(pickle.dumps(e))
    assert type(back) is type(want) and vars(back) == vars(want)


def test_rpc_timeout_is_typed(pkg, endpoints):
    router, _ = endpoints
    with pytest.raises(pkg.rpc.RpcTimeoutError) as ei:
        router.call_sync("nobody", double, (1,), timeout=0.2, retries=0)
    back = pickle.loads(pickle.dumps(ei.value))
    assert type(back) is pkg.rpc.RpcTimeoutError
    assert isinstance(back, TimeoutError)


def test_at_least_once_under_drops_runs_each_handler_once(pkg, endpoints):
    """30% of requests and of replies dropped (seeded): with 6 retries
    every call returns its value, each handler ran exactly once per call
    (the callee's reply cache answers redeliveries), and both retry
    counters moved."""
    router, _ = endpoints
    retries, dups = (pkg.om.counter("rpc_retries_total"),
                     pkg.om.counter("rpc_duplicate_deliveries_total"))
    r0, d0 = retries.value, dups.value
    _plan([{"point": "rpc.send", "action": "drop", "p": 0.3, "seed": 1,
            "src": "router"},
           {"point": "rpc.reply", "action": "drop", "p": 0.3, "seed": 2}])
    del _CALLS[:]
    outs = [router.call_sync("w1", record, (i,), timeout=0.4, retries=6)
            for i in range(12)]
    assert outs == [i + 1 for i in range(12)]
    assert sorted(_CALLS) == list(range(12))
    assert retries.value > r0 and dups.value > d0


def test_duplicates_are_answered_from_the_reply_cache(pkg, endpoints):
    router, _ = endpoints
    _plan([{"point": "rpc.send", "action": "duplicate", "copies": 2}])
    del _CALLS[:]
    assert [router.call_sync("w1", record, (i,), timeout=5.0)
            for i in range(3)] == [1, 2, 3]
    assert sorted(_CALLS) == [0, 1, 2]


def test_envelope_traced_only_inside_a_trace(pkg, endpoints, monkeypatch):
    """5-tuple envelope untraced, 6-tuple with the wire context inside a
    trace (the reference's byte layout, so mixed versions interoperate)."""
    router, _ = endpoints
    seen = []
    attempt = pkg.rpc._RpcAgent._attempt

    def spy(self, to, payload, timeout, fut):
        seen.append(pickle.loads(payload))
        return attempt(self, to, payload, timeout, fut)
    monkeypatch.setattr(pkg.rpc._RpcAgent, "_attempt", spy)
    assert router.call_sync("w1", double, (1,), timeout=10.0) == 2
    ctx = pkg.tracing.adopt("00-" + "ab" * 16 + "-" + "cd" * 8 + "-01")
    with pkg.tracing.activate(ctx):
        assert router.call_sync("w1", double, (2,), timeout=10.0) == 4
    assert [len(env) for env in seen] == [5, 6]
    assert seen[1][5]["trace_id"] == "ab" * 16


def test_endpoint_over_a_lease_store(pkg):
    srv = pkg.LeaseStoreServer()
    store = pkg.LeaseStore(f"127.0.0.1:{srv.port}")
    router = pkg.rpc.RpcEndpoint("router", store=store.clone())
    worker = pkg.rpc.RpcEndpoint("w1", store=store.clone())
    try:
        assert router.call_sync("w1", double, (7,), timeout=10.0) == 14
        assert worker.call_sync("router", double, (3,), timeout=10.0) == 6
    finally:
        worker.stop()
        router.stop()
        store.close()
        srv.stop()


def test_init_rpc_world_of_one(pkg):
    """``init_rpc`` / ``rpc_sync`` / ``rpc_async`` / ``shutdown`` of a
    one-worker mesh (the module-global agent)."""
    pkg.rpc.init_rpc("solo", rank=0, world_size=1,
                     master_endpoint="127.0.0.1:0")
    try:
        assert pkg.rpc.rpc_sync("solo", double, args=(6,)) == 12
        assert pkg.rpc.rpc_async("solo", double, args=(5,)).wait(30) == 10
        assert [w.name for w in pkg.rpc.get_all_worker_infos()] == ["solo"]
        with pytest.raises(RuntimeError, match="already"):
            pkg.rpc.init_rpc("again", rank=0, world_size=1)
    finally:
        pkg.rpc.shutdown()
