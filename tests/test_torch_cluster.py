"""The port's multi-replica serving tier against the reference's
(``tests/test_cluster.py``): the router's choice on the same ``load()``
snapshots (load, prefix affinity, typed backpressure with the smallest
``retry_after``), the cluster's tokens through a ``kill()`` failover and a
``rolling_restart`` (equal to the reference engine's ``fused_kv=False``
path on a fitted tiny model), the crash-loop breaker driven by a
``serve.spawn`` fault, and the tier's HTTP endpoint (``/readyz`` 503
while every replica drains, the merged scrape, ``/debug/profile``).
Every case runs on both packages (``pkg``).
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import torch_stack_common as common

from paddle_tpu.inference import cluster as jax_cluster
from paddle_tpu.inference import serving as jax_serving
from paddle_tpu.observability import metrics as jax_om
from paddle_tpu.testing import faults as jax_faults

from paddle_tpu_torch.inference import cluster, serving
from paddle_tpu_torch.observability import metrics as om
from paddle_tpu_torch.testing import faults

common.one_thread()


class Pkg:
    def __init__(self, name, cl, sv, om_mod, fa, model=None):
        self.name, self.cluster, self.om, self.faults = name, cl, om_mod, fa
        self.ServingCluster = cl.ServingCluster
        self.ClusterRequest = cl.ClusterRequest
        self.ReplicaLostError = cl.ReplicaLostError
        self.AdmissionError = sv.AdmissionError
        self.Engine = sv.LlamaServingEngine
        self.model = model

    def factory(self, **kw):
        geom = dict(common.GEOM, **kw)
        if self.name == "reference":
            geom["fused_kv"] = False
        return lambda: self.Engine(self.model, **geom)


MODS = {"reference": (jax_cluster, jax_serving, jax_om, jax_faults),
        "port": (cluster, serving, om, faults)}


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    arrays = common.fitted_arrays(tmp_path_factory)
    jm = common.reference_model(arrays)
    from paddle_tpu.quant.quality import bundled_prompt_ids
    ids = bundled_prompt_ids(128)
    prompts = [ids[i][:n] for i, n in zip(range(6), (9, 14, 6, 11, 17, 8))]
    return {"reference": jm, "port": common.port_model(arrays),
            "prompts": prompts, "oracle": common.oracle(jm, prompts)}


@pytest.fixture(params=["reference", "port"])
def pkg(request):
    return Pkg(request.param, *MODS[request.param])


@pytest.fixture()
def served(pkg, fitted):
    pkg.model = fitted[pkg.name]
    return pkg


@pytest.fixture(autouse=True)
def _clean_faults():
    for mods in MODS.values():
        mods[3].reset()
    yield
    os.environ.pop(faults.PLAN_ENV, None)
    for mods in MODS.values():
        mods[3].reset()


def _plan(rules):
    os.environ[faults.PLAN_ENV] = json.dumps(rules)
    for mods in MODS.values():
        mods[3].reset()


def _wait(cond, timeout, what):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


# ---------------------------------------------------------------------
# the router's choice on the same load() snapshots
# ---------------------------------------------------------------------
class FakeReplica:
    """A replica that only reports a load snapshot and records what it
    was handed (or sheds with a typed ``retry_after``)."""

    def __init__(self, pkg, rid, load, shed_after=None):
        self.pkg, self.replica_id, self._load = pkg, rid, load
        self.shed_after, self.got = shed_after, []

    def ready(self):
        return True

    def load(self):
        return dict(self._load)

    def submit(self, creq):
        if self.shed_after is not None:
            raise self.pkg.AdmissionError(
                f"{self.replica_id} full", live=2, max_batch=2,
                free_pages=1, num_pages=48, retries=0,
                retry_after=self.shed_after)
        self.got.append(creq)


def _choices(p, tmp_path):
    """The replica picked for each scripted (snapshots, prompt) case, or
    the backpressure error's fields."""
    from paddle_tpu_torch.inference.prefix_cache import chain_keys
    prompt = list(range(40))
    hot = [k.hex() for k in chain_keys(np.asarray(prompt), 8, limit=8)]
    cases = [
        ({"a": {"score": 0.5}, "b": {"score": 0.2}, "c": {"score": 0.9}},
         None),
        ({"a": {"score": 0.5, "prefix_keys": hot, "page_size": 8},
          "b": {"score": 0.2}, "c": {"score": 0.9}}, None),
        ({"a": {"score": 0.5, "prefix_keys": hot[:2], "page_size": 8},
          "b": {"score": 0.2}, "c": {"score": 0.9}}, None),
        ({"a": {"score": 1.6, "prefix_keys": hot, "page_size": 8},
          "b": {"score": 0.2}}, None),
        ({"a": {"score": 0.1}, "b": {"score": 0.4}}, {"a": 2.0}),
        ({"a": {"score": 0.1}, "b": {"score": 0.4}},
         {"a": 2.0, "b": 0.75}),
    ]
    out = []
    for i, (loads, shed) in enumerate(cases):
        c = p.ServingCluster(engine_factory=lambda: None, num_replicas=0,
                             store_path=str(tmp_path / f"{p.name}{i}"),
                             ttl=30.0)
        shed = shed or {}
        for rid, load in loads.items():
            c._replicas[rid] = FakeReplica(p, rid, load, shed.get(rid))
            c.store.register(rid)
        try:
            rep = c._route(p.ClusterRequest(prompt, max_new_tokens=2))
            out.append(("routed", rep.replica_id,
                        c._m["affinity_hits"].value))
        except p.AdmissionError as e:
            out.append(("shed", str(e), e.retry_after, e.free_pages,
                        e.num_pages))
    return out


def test_router_choices_match_reference(tmp_path):
    ref = _choices(Pkg("reference", *MODS["reference"]), tmp_path)
    got = _choices(Pkg("port", *MODS["port"]), tmp_path)
    assert [g[:2] for g in got] == [r[:2] for r in ref]
    assert [g[2:] for g in got if g[0] == "shed"] \
        == [r[2:] for r in ref if r[0] == "shed"]
    picks = [g[1] for g in got]
    # load alone; full and partial affinity (2 of 5 pages) beat a modest
    # load gap; a full batch of load outweighs affinity; a shed replica
    # hands over; every replica shed: the smallest retry_after
    assert picks[:5] == ["b", "a", "a", "b", "b"]
    assert got[5][0] == "shed" and got[5][2] == 0.75


def test_typed_errors_pickle(pkg):
    import pickle
    e = pkg.ReplicaLostError("gone", replica_id="replica-1", failovers=3)
    back = pickle.loads(pickle.dumps(e))
    assert (type(back), str(back), back.replica_id, back.failovers) \
        == (pkg.ReplicaLostError, "gone", "replica-1", 3)
    with pytest.raises(ValueError):
        pkg.ClusterRequest([], max_new_tokens=2)


# ---------------------------------------------------------------------
# tokens through a failover and a rolling restart
# ---------------------------------------------------------------------
def test_kill_failover_and_rolling_restart_keep_tokens_exact(served,
                                                            fitted,
                                                            tmp_path):
    p, prompts, want = served, fitted["prompts"], fitted["oracle"]
    c = p.ServingCluster(p.factory(prefix_cache=False), num_replicas=2,
                         store_path=str(tmp_path / "m"), ttl=10.0).start()
    try:
        fail0, rep0 = c._m["failover"].value, c._m["replaced"].value
        creqs = [c.submit(q, max_new_tokens=common.NEW) for q in prompts]
        victim = c.replicas()["replica-0"]
        assert any(r.replica_id == "replica-0" for r in creqs)
        victim.kill()
        outs = [r.result(timeout=120) for r in creqs]
        assert outs == want
        assert all(r.status == "completed" for r in creqs)
        assert c._m["failover"].value > fail0
        assert sum(r.failovers for r in creqs) >= 1
        _wait(lambda: c._m["replaced"].value > rep0, 60, "the replacement")
        _wait(lambda: all(r.ready() for r in c.replicas().values()), 60,
              "both replicas ready")
        assert c._m["replaced"].value == rep0 + 1, \
            {rid: list(st.deaths) for rid, st in c._restarts.items()}
        # a rolling restart under load: nothing lost, tokens exact
        creqs = [c.submit(q, max_new_tokens=common.NEW) for q in prompts]
        stats = c.rolling_restart(grace=30.0)
        assert sorted(stats) == ["replica-0", "replica-1"]
        outs = [r.result(timeout=120) for r in creqs]
        assert outs == want
        assert all(r.status == "completed" for r in creqs)
        assert c._m["restarts"].value >= 2
        after = [c.submit(q, max_new_tokens=common.NEW) for q in prompts]
        assert [r.result(timeout=120) for r in after] == want
    finally:
        c.stop()


def test_spawn_faults_quarantine_the_replica(pkg, tmp_path):
    _plan([{"point": "serve.spawn", "action": "raise",
            "path": "replica-0"}])
    c = pkg.ServingCluster(engine_factory=lambda: None, num_replicas=1,
                           store_path=str(tmp_path / "m"), ttl=10.0,
                           restart_backoff=0.01, restart_jitter=0.0,
                           breaker_threshold=3, breaker_window=30.0).start()
    try:
        q0 = c._m["quarantined"].value
        _wait(lambda: "replica-0" in c.quarantined(), 20, "quarantine")
        assert c._m["quarantined"].value == q0 + 1
        assert len(c._restarts["replica-0"].deaths) == 3
        with pytest.raises(pkg.AdmissionError) as ei:
            c.submit([1, 2, 3], max_new_tokens=2)
        assert "routable" in str(ei.value)
    finally:
        c.stop()


def test_tier_endpoint(served, fitted, tmp_path):
    """``/readyz`` 200, then 503 while every replica drains; the merged
    scrape names the router; ``/debug/profile`` returns a bundle whose
    profiler started; 400 on a malformed window."""
    p = served
    c = p.ServingCluster(p.factory(), num_replicas=2,
                         store_path=str(tmp_path / "m"), ttl=10.0).start()
    srv = c.start_http_server()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        creqs = [c.submit(q, max_new_tokens=common.NEW)
                 for q in fitted["prompts"][:2]]
        assert [r.result(timeout=120) for r in creqs] \
            == fitted["oracle"][:2]
        assert urllib.request.urlopen(f"{base}/readyz").status == 200
        snap = json.loads(urllib.request.urlopen(
            f"{base}/metrics.json").read())
        fam = {e["name"]: e for e in snap}["router_requests_routed_total"]
        assert fam["labelnames"][0] == "replica"
        assert {s["labels"][0] for s in fam["samples"]} == {"router"}
        health = json.loads(urllib.request.urlopen(f"{base}/healthz").read())
        assert sorted(health["membership"]) == ["replica-0", "replica-1"]
        bundle = json.loads(urllib.request.urlopen(
            f"{base}/debug/profile?seconds=0.2").read())
        assert bundle["capture"]["workers"] == ["router"]
        assert bundle["capture"]["profiler"]["router"]["ok"] is True
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/debug/profile?seconds=x")
        assert ei.value.code == 400
        for rep in c.replicas().values():
            rep.begin_drain()
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/readyz")
        assert ei.value.code == 503
    finally:
        srv.stop()
        c.stop()


# ---------------------------------------------------------------------
# C12: a worker's poll reply carries a live request's tokens so far
# ---------------------------------------------------------------------
class _PollReplica:
    epoch = 3

    def ready(self):
        return True

    def load(self):
        return {"score": 0.0}


@pytest.mark.parametrize("name", ["reference", "port"])
def test_worker_poll_reports_live_partial_output(name):
    """The router's poller mirrors what ``_worker_poll`` reports for a live
    request (``ClusterRequest._mirror_partial``), which is what a
    subprocess replica streams. The port reports the attempt's tokens so
    far; the reference reports ``output_ids``, empty until the request
    ends (ROADMAP C12), so its subprocess streams and its partial output
    stay empty while a request decodes."""
    import importlib
    rw = importlib.import_module(
        ("paddle_tpu" if name == "reference" else "paddle_tpu_torch")
        + ".inference.replica_worker")
    cl, sv = MODS[name][0], MODS[name][1]
    state = rw._WorkerState("r0", _PollReplica())
    creq = cl.ClusterRequest([1, 2, 3], max_new_tokens=4)
    req = sv.Request([1, 2, 3], max_new_tokens=4)
    req.status, req.output_ids = "live", [7, 8]
    creq.request = req
    state._reqs["r0:0"] = creq
    saved, rw._WORKER = rw._WORKER, state
    try:
        rsp = rw._worker_poll(["r0:0"])
    finally:
        rw._WORKER = saved
    live = rsp["requests"]["r0:0"]
    assert live["done"] is False and rsp["epoch"] == 3
    assert live["output_ids"] == ([] if name == "reference" else [7, 8])


# ---------------------------------------------------------------------
# C13: a restart waits for the killed incarnation's dispatch
# ---------------------------------------------------------------------
class _SlowEngine:
    """An engine whose dispatch blocks until ``gate`` opens, standing in
    for a decode burst that outlasts the death handler's join."""
    max_batch = 2

    def __init__(self, log):
        self.log = log
        self.entered = threading.Event()
        self.gate = threading.Event()
        self._live = {0: type("Live", (), {"done": False})()}

    def step(self):
        self.entered.set()
        self.gate.wait(10.0)
        self.log.append("step returned")
        self._live = {}
        return 1

    def is_ready(self):
        return True

    def close(self):
        self.log.append("closed")


@pytest.mark.parametrize("name", ["reference", "port"])
def test_restart_waits_for_the_killed_dispatch(name):
    """A killed in-process replica whose worker is still inside a dispatch
    when the supervisor restarts it (the death handler joins it for 1 s).
    The port's ``restart`` waits for that dispatch, closes the old engine
    after it, and comes back alive: one death, one replacement. The
    reference's closes the engine under the running dispatch and its
    ``start`` returns early on the old thread, leaving the replica dead,
    so its supervisor counts a second death and a second replacement
    (ROADMAP C13)."""
    cl = MODS[name][0]
    log = []
    engines = []

    def factory():
        engines.append(_SlowEngine(log))
        return engines[-1]

    rep = cl.EngineReplica("r0", factory, burst=None).start()
    old = engines[0]
    assert old.entered.wait(10.0)
    rep.kill()
    rep.stop_worker(timeout=0.05)
    timer = threading.Timer(0.5, old.gate.set)
    timer.start()
    try:
        rep.restart()
        alive = rep.alive()
    finally:
        timer.cancel()
        old.gate.set()
        rep.stop_worker(timeout=5.0)
        for e in engines:
            e.gate.set()
    if name == "port":
        assert alive and len(engines) == 2
        assert log[:2] == ["step returned", "closed"]
    else:
        assert not alive and log[0] == "closed"
