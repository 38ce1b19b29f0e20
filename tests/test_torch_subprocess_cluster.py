"""The port's process-isolated replicas (``SubprocessReplica`` over
``python -m paddle_tpu_torch.inference.replica_worker``) against the
reference (``tests/test_subprocess_cluster.py``, ``tests/test_net_store.py``):
two worker processes load the fitted tiny model through a factory module
(``tests/torch_stack_factory.py``, the weights from an ``.npz`` the test
wrote) and serve over rpc; their tokens equal the reference engine's
``fused_kv=False`` path through a real SIGKILL of one worker, and in a
TCP-only deployment whose membership and mailboxes ride a
``LeaseStoreServer``. The replacement reports its restart time and
compile-cache stats, the one-pane scrape merges both workers under
``replica``, and a cluster-wide profile capture returns a shard from the
router and from each live worker. The workers run the port only (the
reference's worker processes would compile their programs with XLA each,
beyond this file's time budget); every worker gets one OpenMP thread
(``OMP_NUM_THREADS=1`` through ``subprocess_env``).
"""

import os
import threading
import time

import pytest

import torch_stack_common as common

from paddle_tpu_torch.distributed.net_store import LeaseStoreServer
from paddle_tpu_torch.inference import ServingCluster
from paddle_tpu_torch.observability.export import aggregate_snapshot
from paddle_tpu_torch.testing import faults

common.one_thread()

SPEC = {"model": {"factory": "tests.torch_stack_factory:build_model"},
        "engine": dict(common.GEOM, prefix_cache=False)}


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    path = common.fitted_path(tmp_path_factory)
    with_arrays = common.fitted_arrays(tmp_path_factory)
    jm = common.reference_model(with_arrays)
    from paddle_tpu.quant.quality import bundled_prompt_ids
    ids = bundled_prompt_ids(128)
    prompts = [ids[i][:n] for i, n in zip(range(4), (9, 14, 6, 11))]
    return {"path": str(path), "prompts": prompts,
            "oracle": common.oracle(jm, prompts)}


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    yield
    os.environ.pop(faults.PLAN_ENV, None)
    faults.reset()


def _env(fitted, tmp_path):
    return {"OMP_NUM_THREADS": "1",
            "PADDLE_TPU_TEST_WEIGHTS": fitted["path"],
            "PADDLE_TPU_COMPILE_CACHE_DIR": str(tmp_path / "cache"),
            "PADDLE_TPU_SHAPE_REGISTRY": str(tmp_path / "shapes.json"),
            "PADDLE_TPU_TRACE_FLUSH": "0.2"}


def _wait(cond, timeout, what):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _teardown(c):
    """Stop the supervisor, then the workers' clean exits side by side
    (each costs its rpc dispatcher's join of seconds), then the
    cluster."""
    c._stop.set()
    c._monitor_thread.join(timeout=5.0)
    stoppers = [threading.Thread(target=rep.stop)
                for rep in c.replicas().values()]
    for th in stoppers:
        th.start()
    for th in stoppers:
        th.join(timeout=30.0)
    c.stop()
    assert all(r._proc.poll() is not None for r in c.replicas().values())


def test_sigkill_failover_warm_restart_and_one_pane(fitted, tmp_path):
    log_dir = tmp_path / "logs"
    c = ServingCluster(engine_spec=SPEC, num_replicas=2, ttl=5.0,
                       store_path=str(tmp_path / "m"), log_dir=str(log_dir),
                       subprocess_env=_env(fitted, tmp_path)).start()
    try:
        reps = c.replicas()
        _wait(lambda: all(r.ready() for r in reps.values()), 60,
              "both workers ready")
        first = {rid: r.restart_ttft for rid, r in reps.items()}
        proc0 = reps["replica-0"]._proc
        creqs = [c.submit(q, max_new_tokens=common.NEW)
                 for q in fitted["prompts"]]
        assert any(r.replica_id == "replica-0" for r in creqs)
        reps["replica-0"].kill()            # a real SIGKILL
        outs = [r.result(timeout=60) for r in creqs]
        assert outs == fitted["oracle"]
        assert all(r.status == "completed" for r in creqs)
        assert sum(r.failovers for r in creqs) >= 1
        assert proc0.wait(timeout=10) == -9
        _wait(lambda: reps["replica-0"].ready()
              and reps["replica-0"]._proc is not proc0, 60,
              "the replacement")
        rep = reps["replica-0"]
        assert rep.restart_ttft is not None and all(first.values())
        assert set(rep.cache_stats) == {"hits", "misses", "dir"}
        after = [c.submit(q, max_new_tokens=common.NEW)
                 for q in fitted["prompts"]]
        assert [r.result(timeout=60) for r in after] == fitted["oracle"]
        # one pane: both workers' registries under `replica`
        snap = c.scrape()
        fam = {e["name"]: e for e in snap}
        gen = fam["serving_generated_tokens_total"]
        assert gen["labelnames"][0] == "replica"
        per = {s["labels"][0]: s["value"] for s in gen["samples"]}
        assert {"replica-0", "replica-1"} <= set(per)
        agg = {e["name"]: e for e in aggregate_snapshot(snap)}
        assert agg["serving_generated_tokens_total"]["samples"][0]["value"] \
            == sum(per.values())
        # a profile window over the router and both live workers
        bundle = c.capture_profile(0.3)
        assert sorted(bundle["capture"]["workers"]) \
            == ["replica-0", "replica-1", "router"]
        assert all(p["ok"] for p in bundle["capture"]["profiler"].values())
        assert len(bundle["capture"]["pids"]) == 3
        # the workers built the same weights (their logs' digests)
        digests = {line.split("weights_sha256=")[1].strip()
                   for f in os.listdir(log_dir) if f.endswith(".log")
                   for line in open(log_dir / f)
                   if "weights_sha256=" in line}
        assert len(digests) == 1
    finally:
        _teardown(c)


def test_tcp_only_cluster_over_a_lease_store(fitted, tmp_path):
    """No shared filesystem: membership and every rpc mailbox ride one
    ``LeaseStoreServer``; the tokens are the oracle's."""
    srv = LeaseStoreServer()
    c = ServingCluster(engine_spec=SPEC, num_replicas=2, ttl=5.0,
                       store_addr=f"127.0.0.1:{srv.port}",
                       subprocess_env=_env(fitted, tmp_path)).start()
    try:
        reps = c.replicas()
        _wait(lambda: all(r.ready() for r in reps.values()), 60,
              "both workers ready")
        assert sorted(c.store.hosts()) == ["replica-0", "replica-1"]
        creqs = [c.submit(q, max_new_tokens=common.NEW)
                 for q in fitted["prompts"]]
        assert [r.result(timeout=60) for r in creqs] == fitted["oracle"]
        assert all(r.epoch is not None and r.epoch >= 1
                   for r in reps.values())
    finally:
        _teardown(c)
        srv.stop()
