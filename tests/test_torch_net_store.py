"""The port's control-plane stores and fault rules against the
reference's (``tests/test_net_store.py``, ``tests/test_partition_tolerance.py``):
``FileStore`` and the TCP ``LeaseStore`` (register, TTL ageing, epochs
and fencing, the KV surface), the native ``TCPStore``, the typed outage
and fencing errors' pickle round trips, and the network and store fault
rules' verdicts under seeded plans. Every case runs on both packages
(``pkg``); the verdict sequences and a scripted membership history are
held equal across them.
"""

import json
import os
import pickle
import socket
import threading
import time

import pytest
import torch

from paddle_tpu import native as jax_native
from paddle_tpu.distributed import net_store as jax_net_store
from paddle_tpu.distributed import watchdog as jax_watchdog
from paddle_tpu.observability import metrics as jax_om
from paddle_tpu.testing import faults as jax_faults

from paddle_tpu_torch import native
from paddle_tpu_torch.distributed import net_store, watchdog
from paddle_tpu_torch.observability import metrics as om
from paddle_tpu_torch.testing import faults

# One intra-op thread a process (the suite runs in xdist workers).
torch.set_num_threads(1)


class Pkg:
    def __init__(self, name, native_mod, ns, wd, om_mod, faults_mod):
        self.name = name
        self.native, self.faults, self.om = native_mod, faults_mod, om_mod
        self.LeaseStore, self.LeaseStoreServer = ns.LeaseStore, \
            ns.LeaseStoreServer
        self.StoreUnavailableError = ns.StoreUnavailableError
        self.parse_addr = ns.parse_addr
        self.FileStore, self.StaleEpochError = wd.FileStore, \
            wd.StaleEpochError
        self.ElasticManager = wd.ElasticManager


PKGS = {"reference": Pkg("reference", jax_native, jax_net_store,
                         jax_watchdog, jax_om, jax_faults),
        "port": Pkg("port", native, net_store, watchdog, om, faults)}


@pytest.fixture(params=["reference", "port"])
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


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class _Store:
    """``kind`` store of ``pkg`` (a lease store has its own server)."""

    def __init__(self, pkg, kind, path, ttl):
        self.srv = None
        if kind == "file":
            self.store = pkg.FileStore(str(path), ttl=ttl)
        else:
            self.srv = pkg.LeaseStoreServer()
            self.store = pkg.LeaseStore(f"127.0.0.1:{self.srv.port}",
                                        ttl=ttl)

    def close(self):
        if self.srv is not None:
            self.store.close()
            self.srv.stop()


@pytest.fixture(params=["file", "lease"])
def store(request, pkg, tmp_path):
    s = _Store(pkg, request.param, tmp_path / "m", 0.3)
    yield s.store
    s.close()


# ---------------------------------------------------------------------
# the store contract, both backends, both packages
# ---------------------------------------------------------------------
def test_register_hosts_deregister(store):
    assert store.hosts() == []
    store.register("r0")
    store.register("r1")
    assert store.hosts() == ["r0", "r1"]
    store.deregister("r0")
    store.deregister("r0")                  # idempotent
    assert store.hosts() == ["r1"]
    assert store.heartbeat_age("ghost") is None
    assert 0.0 <= store.heartbeat_age("r1") < 0.3


def test_heartbeat_refreshes_and_ttl_ages_out(store):
    store.register("r0")
    time.sleep(0.2)
    assert store.heartbeat("r0") is True
    time.sleep(0.2)
    assert "r0" in store.hosts()            # 0.2 s after the beat
    time.sleep(0.45)
    assert "r0" not in store.hosts()


def test_epoch_fencing(pkg, store):
    e1 = store.next_epoch("r0")
    store.register("r0", epoch=e1)
    assert store.heartbeat("r0", epoch=e1) is True
    e2 = store.next_epoch("r0")
    store.register("r0", epoch=e2)
    m = pkg.om.counter("cluster_stale_epoch_rejections_total")
    c0 = m.value
    with pytest.raises(pkg.StaleEpochError) as ei:
        store.heartbeat("r0", epoch=e1)
    assert (ei.value.host_id, ei.value.epoch, ei.value.current) \
        == ("r0", e1, e2)
    with pytest.raises(pkg.StaleEpochError):
        store.check_epoch("r0", e1)
    assert m.value == c0 + 2
    # the fence outlives the name's registration
    store.deregister("r0")
    store.next_epoch("r0")
    with pytest.raises(pkg.StaleEpochError):
        store.register("r0", epoch=e2)
    assert store.hosts() == []
    assert [store.next_epoch("a") for _ in range(3)] == [1, 2, 3]
    assert store.epoch_of("a") == 3 and store.epoch_of("b") is None


def test_elastic_manager_sees_scale_events(pkg, store):
    em = pkg.ElasticManager(store, "router", 1)
    store.register("r0")
    assert em.watch_once() == "normal"
    store.register("r1")
    assert em.watch_once() == "scale_up"
    store.deregister("r1")
    store.deregister("r0")
    assert em.watch_once() == "scale_down"


def _membership_history(p, kind, tmp_path):
    """One scripted membership history: what each step returned or
    raised."""
    s = _Store(p, kind, tmp_path / f"{p.name}-{kind}", 5.0)
    st, out = s.store, []

    def step(fn, *a, **kw):
        try:
            out.append(("ok", fn(*a, **kw)))
        except p.StaleEpochError as e:
            out.append(("stale", e.host_id, e.epoch, e.current))
    try:
        for rid in ("r0", "r1", "r2"):
            e = st.next_epoch(rid)
            step(st.register, rid, epoch=e)
        step(st.hosts)
        step(st.next_epoch, "r1")
        step(st.heartbeat, "r1", epoch=1)
        step(st.heartbeat, "r1", epoch=2)
        step(st.deregister, "r2")
        step(st.register, "r2", epoch=1)
        step(st.hosts)
        step(st.epoch_of, "r1")
        step(st.check_epoch, "r0", 1)
        step(st.check_epoch, "r0", 0)
    finally:
        s.close()
    return out


@pytest.mark.parametrize("kind", ["file", "lease"])
def test_membership_history_matches_reference(kind, tmp_path):
    ref = _membership_history(PKGS["reference"], kind, tmp_path)
    assert _membership_history(PKGS["port"], kind, tmp_path) == ref
    assert ("stale", "r1", 1, 2) in ref


# ---------------------------------------------------------------------
# the lease store's KV surface and the native TCPStore
# ---------------------------------------------------------------------
def test_lease_store_kv(pkg):
    srv = pkg.LeaseStoreServer()
    kv = pkg.LeaseStore(f"127.0.0.1:{srv.port}")
    other = kv.clone()
    try:
        kv.set("k", b"\x00binary\xff")
        kv.set("s", "text")
        assert (kv.get("k"), kv.get("s")) == (b"\x00binary\xff", b"text")
        t = threading.Timer(0.1, lambda: other.set("late", b"v"))
        t.start()
        assert kv.get("late", timeout=5.0) == b"v"
        t.join()
        with pytest.raises(TimeoutError) as ei:
            kv.get("never", timeout=0.05)
        assert not isinstance(ei.value, pkg.StoreUnavailableError)
        assert (kv.add("c", 5), kv.add("c", -2)) == (5, 3)
        assert int.from_bytes(kv.get("c"), "little", signed=True) == 3
        kv.wait(["k"], timeout=1.0)
        assert (kv.delete_key("k"), kv.delete_key("k")) == (True, False)
        kv.barrier(1, tag="t0", timeout=5.0)
    finally:
        other.close()
        kv.close()
        srv.stop()


def test_native_tcp_store(pkg):
    assert pkg.native.available(), pkg.native.__name__
    master = pkg.native.TCPStore(is_master=True, port=0)
    client = pkg.native.TCPStore(port=master.port)
    try:
        client.set("k", b"v")
        assert master.get("k") == b"v"
        assert (client.add("n", 2), master.add("n", 3)) == (2, 5)
        with pytest.raises(TimeoutError):
            client.get("missing", timeout=0.05)
        assert client.delete_key("k") and not client.delete_key("k")
        assert master.num_keys() >= 1
    finally:
        master.close()
    # the master gone: transport failures are typed, never a bare error
    with pytest.raises(pkg.StoreUnavailableError) as ei:
        client.set("k", b"v")
    assert ei.value.op == "set"
    with pytest.raises(pkg.StoreUnavailableError):
        client.add("k", 1)
    client.close()


def test_typed_errors_pickle(pkg):
    e = pkg.StoreUnavailableError("10.0.0.5:2379", "heartbeat",
                                  detail="boom")
    assert isinstance(e, ConnectionError)
    e2 = pickle.loads(pickle.dumps(e))
    assert type(e2) is pkg.StoreUnavailableError
    assert (e2.addr, e2.op, e2.detail, str(e2)) \
        == ("10.0.0.5:2379", "heartbeat", "boom", str(e))
    s = pkg.StaleEpochError("r0", 1, 3)
    s2 = pickle.loads(pickle.dumps(s))
    assert type(s2) is pkg.StaleEpochError
    assert (s2.host_id, s2.epoch, s2.current, str(s2)) \
        == ("r0", 1, 3, str(s))
    assert pkg.parse_addr("10.0.0.5:2379") == ("10.0.0.5", 2379)
    assert pkg.parse_addr(":80") == ("127.0.0.1", 80)


def test_unreachable_store_raises_typed(pkg):
    st = pkg.LeaseStore(f"127.0.0.1:{_free_port()}", retries=1,
                        backoff=0.01)
    with pytest.raises(pkg.StoreUnavailableError) as ei:
        st.ping()
    assert (ei.value.op, ei.value.addr) == ("ping", st.addr)
    assert st.outage_age() > 0.0
    st.close()


# ---------------------------------------------------------------------
# network and store fault rules: the same verdicts from the same plan
# ---------------------------------------------------------------------
NET_PLAN = [
    {"point": "rpc.send", "action": "drop", "p": 0.3, "seed": 7,
     "src": "router", "dst": "replica-*"},
    {"point": "rpc.send", "action": "delay", "seconds": 0.01, "p": 0.5,
     "seed": 3},
    {"point": "rpc.reply", "action": "duplicate", "copies": 2, "p": 0.4,
     "seed": 11},
    {"point": "rpc.reply", "action": "reorder", "seconds": 0.2, "seed": 5,
     "count": 4},
    {"point": "store.heartbeat", "action": "partition", "src": "replica-1",
     "seconds": 60.0},
]
STORE_PLAN = [
    {"point": "store.connect", "action": "refuse", "p": 0.25, "seed": 2},
    {"point": "store.frame", "action": "slow", "seconds": 0.02, "p": 0.5,
     "seed": 9, "path": "heart*"},
    {"point": "store.frame", "action": "reset", "step": 4},
    {"point": "store.frame", "action": "torn", "count": 2, "path": "get"},
    {"point": "store.frame", "action": "hang", "seconds": 0.5, "step": 7},
]


def _verdicts(p):
    out = []
    for i in range(40):
        for point, src, dst in (("rpc.send", "router", f"replica-{i % 3}"),
                                ("rpc.reply", f"replica-{i % 2}", "router"),
                                ("store.heartbeat", f"replica-{i % 2}",
                                 "store")):
            v = p.faults.fire_network(point, src=src, dst=dst, step=i)
            out.append((bool(v), v.drop, round(v.delay, 9),
                        round(v.hold, 9), v.copies))
        for point, path in (("store.connect", "127.0.0.1:1"),
                            ("store.frame", "heartbeat"),
                            ("store.frame", "get")):
            v = p.faults.fire_store(point, step=i, path=path)
            out.append((bool(v), v.refuse, v.reset, v.hang, v.slow, v.torn))
    return out


def test_fault_rule_verdicts_match_reference():
    _plan(NET_PLAN + STORE_PLAN)
    ref = _verdicts(PKGS["reference"])
    got = _verdicts(PKGS["port"])
    assert got == ref
    # every action fired, and the partition dropped all of replica-1's
    # heartbeats inside its window
    assert any(v[1] for v in got[0::6]) and any(v[2] for v in got[0::6])
    assert any(v[4] for v in got[1::6]) and any(v[3] for v in got[1::6])
    assert all(v[1] == (i % 2 == 1) for i, v in enumerate(got[2::6]))
    assert any(v[1] for v in got[3::6]) and any(v[4] for v in got[4::6])
    assert any(v[2] for v in got[4::6]) and any(v[3] for v in got[4::6])
    assert sum(v[5] for v in got[5::6]) == 2


def test_no_plan_is_a_falsy_shared_verdict(pkg):
    assert not pkg.faults.fire_network("rpc.send", src="a", dst="b")
    assert not pkg.faults.fire_store("store.frame", path="get")


@pytest.mark.parametrize("rule", [
    {"point": "rpc.sned", "action": "drop"},
    {"point": "rpc.send", "action": "drop", "bogus": 1},
    {"point": "store.frame", "action": "explode"},
    {"point": "rpc.send", "action": "drop", "p": 2.0},
])
def test_bad_network_rules_fail_at_parse_time(pkg, rule):
    with pytest.raises(ValueError) as ei:
        pkg.faults.FaultPlan([rule])
    other = PKGS["reference" if pkg.name == "port" else "port"]
    with pytest.raises(ValueError) as e2:
        other.faults.FaultPlan([rule])
    assert str(ei.value) == str(e2.value)


def test_network_rule_drops_a_filestore_heartbeat(pkg, tmp_path):
    """The ``store.heartbeat`` message point fires in ``FileStore``: a
    partitioned replica's beat is dropped (returns False) and it ages
    out."""
    st = pkg.FileStore(str(tmp_path / "m"), ttl=0.2)
    st.register("replica-1")
    _plan([{"point": "store.heartbeat", "action": "partition",
            "src": "replica-1", "seconds": 30.0}])
    assert st.heartbeat("replica-1") is False
    time.sleep(0.3)
    assert st.hosts() == []
