"""The port's multi-tenant QoS gate against the reference's
(``tests/test_qos.py``): token buckets, shedding with a typed
``retry_after``, settle-time debiting, the priority classes, the
concurrency cap and SLO-breach accounting. Every case runs on both
packages (``pkg``) under a fake clock, so the refill arithmetic is exact;
one scripted admit/settle sequence is held equal across the packages,
decision by decision, with the eight ``serving_tenant_*`` families'
samples.
"""

import pickle

import pytest
import torch

from paddle_tpu.inference import qos as jax_qos
from paddle_tpu.inference import serving as jax_serving
from paddle_tpu.observability import export as jax_export

from paddle_tpu_torch.inference import qos, serving
from paddle_tpu_torch.observability import export

# One intra-op thread a process (the suite runs in xdist workers).
torch.set_num_threads(1)

PKGS = {"reference": (jax_qos, jax_serving, jax_export),
        "port": (qos, serving, export)}


class Pkg:
    def __init__(self, name):
        self.name = name
        self.qos, self.serving, self.export = PKGS[name]
        self.QosGate, self.Tenant = self.qos.QosGate, self.qos.Tenant
        self.CLASS_PRIORITY = self.qos.CLASS_PRIORITY
        self.AdmissionError = self.serving.AdmissionError


@pytest.fixture(params=["reference", "port"])
def pkg(request):
    return Pkg(request.param)


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture()
def clock():
    return FakeClock()


def test_tenant_validation(pkg):
    with pytest.raises(ValueError, match="unknown tier"):
        pkg.Tenant("x", tier="gold")
    with pytest.raises(ValueError, match="rate"):
        pkg.Tenant("x", rate=0)
    t = pkg.Tenant("x", tier="premium")
    assert t.priority == pkg.CLASS_PRIORITY["premium"]
    assert pkg.Tenant("y", priority=7).priority == 7
    assert pkg.Tenant("z", rate=100).burst == 400.0
    assert pkg.CLASS_PRIORITY == {"batch": 0, "standard": 1, "premium": 2}


def test_admit_and_settle_debits_bucket(pkg, clock):
    gate = pkg.QosGate([pkg.Tenant("a", rate=100, burst=200)], clock=clock)
    g = gate.admit("a", max_tokens=50)
    assert g.priority == pkg.CLASS_PRIORITY["standard"]
    gate.settle(g, completed_tokens=150)
    gate.settle(g, completed_tokens=150)     # a second settle is a no-op
    snap = gate.snapshot()["a"]
    assert snap["bucket"] == 50.0 and snap["inflight"] == 0


def test_shed_when_bucket_empty_with_retry_after(pkg, clock):
    gate = pkg.QosGate([pkg.Tenant("a", rate=10, burst=40)], clock=clock)
    gate.settle(gate.admit("a"), completed_tokens=100)   # bucket at -60
    with pytest.raises(pkg.AdmissionError) as ei:
        gate.admit("a")
    assert ei.value.retry_after == pytest.approx(6.1)
    clock.advance(7.0)
    assert gate.admit("a") is not None


def test_flood_pays_for_itself_only(pkg, clock):
    gate = pkg.QosGate([pkg.Tenant("flood", rate=10, burst=10),
                        pkg.Tenant("prem", tier="premium", rate=1000)],
                       clock=clock)
    gate.settle(gate.admit("flood"), completed_tokens=500)
    with pytest.raises(pkg.AdmissionError):
        gate.admit("flood")
    assert gate.admit("prem").priority == pkg.CLASS_PRIORITY["premium"]


def test_unmetered_tenant_never_sheds(pkg, clock):
    gate = pkg.QosGate([pkg.Tenant("a")], clock=clock)
    for _ in range(100):
        gate.settle(gate.admit("a"), completed_tokens=10 ** 6)
    assert gate.snapshot()["a"]["bucket"] is None


def test_concurrency_cap(pkg, clock):
    gate = pkg.QosGate([pkg.Tenant("a", max_inflight=2)], clock=clock)
    g1 = gate.admit("a")
    gate.admit("a")
    with pytest.raises(pkg.AdmissionError, match="concurrency cap"):
        gate.admit("a")
    gate.settle(g1)
    gate.admit("a")


def test_unknown_tenant_gets_default_spec(pkg, clock):
    gate = pkg.QosGate(default_spec={"tier": "batch", "rate": 5,
                                     "burst": 5}, clock=clock)
    g = gate.admit("surprise")
    assert g.priority == pkg.CLASS_PRIORITY["batch"]
    gate.settle(g, completed_tokens=50)
    with pytest.raises(pkg.AdmissionError):
        gate.admit("surprise")


def test_slo_breach_accounting(pkg, clock):
    gate = pkg.QosGate([pkg.Tenant("a", ttft_slo=0.5, tpot_slo=0.01)],
                       clock=clock)
    m = gate._m["breaches"]
    base = m.labels("a", "ttft")._value, m.labels("a", "tpot")._value
    gate.settle(gate.admit("a"), completed_tokens=4, ttft=0.2, tpot=0.005)
    assert (m.labels("a", "ttft")._value,
            m.labels("a", "tpot")._value) == base
    gate.settle(gate.admit("a"), completed_tokens=4, ttft=0.9, tpot=0.02)
    assert m.labels("a", "ttft")._value == base[0] + 1
    assert m.labels("a", "tpot")._value == base[1] + 1


def test_optimistic_admission_costs_nothing_on_shed(pkg, clock):
    gate = pkg.QosGate([pkg.Tenant("a", rate=10, burst=100)], clock=clock)
    gate.settle(gate.admit("a", max_tokens=10 ** 6), completed_tokens=0)
    assert gate.snapshot()["a"]["bucket"] == 100.0


def test_shed_error_pickles_with_its_fields(pkg, clock):
    gate = pkg.QosGate([pkg.Tenant("a", rate=10, burst=10)], clock=clock)
    gate.settle(gate.admit("a"), completed_tokens=30)
    with pytest.raises(pkg.AdmissionError) as ei:
        gate.admit("a")
    back = pickle.loads(pickle.dumps(ei.value))
    assert type(back) is pkg.AdmissionError
    assert (str(back), back.retry_after) \
        == (str(ei.value), ei.value.retry_after)


# ---------------------------------------------------------------------
# one scripted sequence, both packages, decision by decision
# ---------------------------------------------------------------------
SCRIPT = (("admit", "s-prem", 64), ("admit", "s-flood", 16),
          ("settle", 1, 120, 0.2, 0.004), ("admit", "s-flood", 16),
          ("tick", 3.0), ("admit", "s-flood", 16), ("admit", "s-cap", 0),
          ("admit", "s-cap", 0), ("admit", "s-cap", 0),
          ("settle", 0, 300, 0.9, 0.03), ("admit", "s-new", 8),
          ("settle", 7, 2, 0.01, 0.001), ("tick", 10.0),
          ("admit", "s-flood", 16), ("settle", 0, 5, None, None),
          ("settle", 4, 0, None, None), ("admit", "s-cap", 0))


def _run_script(p):
    clock = FakeClock()
    gate = p.QosGate([p.Tenant("s-prem", tier="premium", rate=50,
                               ttft_slo=0.5, tpot_slo=0.01),
                      p.Tenant("s-flood", tier="batch", rate=10, burst=40),
                      p.Tenant("s-cap", max_inflight=2)],
                     default_spec={"tier": "batch", "rate": 1, "burst": 4},
                     clock=clock)
    grants, trace = [], []
    for step in SCRIPT:
        if step[0] == "tick":
            clock.advance(step[1])
            continue
        if step[0] == "admit":
            try:
                g = gate.admit(step[1], max_tokens=step[2])
                grants.append(g)
                trace.append(("granted", g.priority))
            except p.AdmissionError as e:
                grants.append(None)
                trace.append(("shed", str(e), e.retry_after))
        else:
            _, i, tokens, ttft, tpot = step
            gate.settle(grants[i], completed_tokens=tokens, ttft=ttft,
                        tpot=tpot)
            trace.append(("settled", i))
        trace.append(("snapshot", gate.snapshot()))
    families = {}
    for fam in p.export.json_snapshot():
        if not fam["name"].startswith("serving_tenant_"):
            continue
        families[fam["name"]] = sorted(
            (tuple(s["labels"]), s.get("value"), tuple(s.get("counts", ())))
            for s in fam["samples"]
            if str(s["labels"][0]).startswith("s-"))
    return trace, families


def test_scripted_sequence_matches_reference():
    ref_trace, ref_families = _run_script(Pkg("reference"))
    trace, families = _run_script(Pkg("port"))
    assert trace == ref_trace
    assert len(families) == 8
    assert families == ref_families
    assert any(t[0] == "shed" for t in trace) \
        and any(t[0] == "granted" for t in trace)
