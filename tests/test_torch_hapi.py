"""The port's ``hapi`` (``Model``, the callbacks, ``summary`` / ``flops``,
``hub``) against the reference package's.

The toy network is the reference tests' (``tests/test_hapi.py``'s
``ToyData`` and 4-16-2 MLP) with the reference's weights carried across
(its ``[in, out]`` Linear weights transposed into torch's ``[out, in]``),
batches drawn by a ``RandomSampler`` with an int generator on both sides.

Tolerances: 1e-5 relative for f32 losses (``fit`` against the reference
with ``jit=True`` and ``jit=False``, ``evaluate``, ``predict``, also with
``amp_configs`` O1); 2e-2 absolute, the O1 loss curve's, for the O2
``fit`` and ``evaluate``; exact for metric values, callback decisions
(the epoch ``EarlyStopping`` stops at, the learning rates
``LRScheduler`` steps through, the steps ``CheckpointCallback`` saves and
restores), parameter counts and FLOPs; bitwise for ``Model.save`` /
``load`` and for the O2 ``predict`` against the reference network under
its O2 ``auto_cast``.
"""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as TF

import paddle_tpu as paddle
import paddle_tpu.nn as pnn
from paddle_tpu import hapi as rh
from paddle_tpu import io as rio
from paddle_tpu import metric as rm

from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import hapi as th
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import metric as tm
from paddle_tpu_torch.observability import metrics as om
from paddle_tpu_torch.optimizer import AdamW, lr

torch.set_num_threads(1)


class ToyData:
    """Linearly separable 2-class problem (the reference tests')."""

    def __init__(self, n=128, seed=0):
        rng = np.random.RandomState(seed)
        self.x = rng.randn(n, 4).astype("float32")
        w = np.asarray([1.0, -2.0, 0.5, 1.5], "float32")
        self.y = (self.x @ w > 0).astype("int64")

    def __getitem__(self, i):
        return self.x[i], self.y[i]

    def __len__(self):
        return len(self.x)


def _loader(mod, data, gen=3, bs=32):
    return mod.DataLoader(data, batch_sampler=mod.BatchSampler(
        sampler=mod.RandomSampler(data, generator=gen), batch_size=bs))


def _ce(logits, label):
    return TF.cross_entropy(logits, label)


def _pair(jit, sched=None, metrics=True, amp=None, ref_jit=None):
    """The reference's Model and the port's over the same weights;
    ``amp`` ("O1" or "O2") prepares both with ``amp_configs``, "O2"
    after ``amp.decorate`` of network and optimizer on each side."""
    paddle.seed(0)
    jnet = pnn.Sequential(pnn.Linear(4, 16), pnn.ReLU(), pnn.Linear(16, 2))
    jopt = paddle.optimizer.AdamW(learning_rate=sched[0] if sched else 0.03,
                                  parameters=jnet.parameters())
    tnet = torch.nn.Sequential(torch.nn.Linear(4, 16), torch.nn.ReLU(),
                               torch.nn.Linear(16, 2))
    with torch.no_grad():
        for i in (0, 2):
            tnet[i].weight.copy_(torch.tensor(
                np.asarray(jnet[i].weight.numpy()).T))
            tnet[i].bias.copy_(torch.tensor(np.asarray(jnet[i].bias.numpy())))
    topt = AdamW(learning_rate=sched[1] if sched else 0.03,
                 parameters=tnet.parameters())
    if amp == "O2":
        jnet, jopt = paddle.amp.decorate(jnet, jopt, level="O2")
        tnet, topt = tamp.decorate(tnet, topt, level="O2")
    cfg = {"level": amp} if amp else None
    jm = rh.Model(jnet)
    jm.prepare(optimizer=jopt, loss=pnn.CrossEntropyLoss(),
               metrics=[rm.Accuracy()] if metrics else [],
               jit=jit if ref_jit is None else ref_jit, amp_configs=cfg)
    tmod = th.Model(tnet)
    tmod.prepare(optimizer=topt, loss=_ce,
                 metrics=[tm.Accuracy()] if metrics else [], jit=jit,
                 amp_configs=cfg)
    return jm, tmod


def _close_logs(got, want):
    assert set(got) == set(want)
    for k in want:
        if "acc" in k:
            assert got[k] == want[k], k
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       err_msg=k)


@pytest.mark.parametrize("jit", [False, True])
def test_fit_evaluate_predict_match_reference(jit):
    jm, tmod = _pair(jit)
    hj = jm.fit(_loader(rio, ToyData()), eval_data=ToyData(seed=1),
                batch_size=32, epochs=2, verbose=0)
    ht = tmod.fit(_loader(tio, ToyData()), eval_data=ToyData(seed=1),
                  batch_size=32, epochs=2, verbose=0)
    assert len(ht.history) == len(hj.history) == 2
    for a, b in zip(ht.history, hj.history):
        _close_logs(a, b)
    _close_logs(tmod.evaluate(ToyData(seed=2), batch_size=32, verbose=0),
                jm.evaluate(ToyData(seed=2), batch_size=32, verbose=0))
    pt = tmod.predict(ToyData(seed=3), batch_size=64)
    pj = jm.predict(ToyData(seed=3), batch_size=64)
    assert pt[0].shape == pj[0].shape == (128, 2)
    np.testing.assert_allclose(pt[0], pj[0], rtol=1e-5, atol=1e-6)
    if jit:
        step = tmod._train_step
        assert isinstance(step, th.jit_mod.StaticFunction)
        assert step._watch_name == "hapi.train_step"


def test_o1_evaluate_predict_match_reference():
    """An f32 network prepared with ``amp_configs`` O1 evaluates and
    predicts outside ``auto_cast``, as the reference does: f32 values
    within 1e-5 of the reference's."""
    jm, tmod = _pair(False, amp="O1")
    _close_logs(tmod.evaluate(ToyData(seed=2), batch_size=32, verbose=0),
                jm.evaluate(ToyData(seed=2), batch_size=32, verbose=0))
    pt = tmod.predict(ToyData(seed=3), batch_size=64)
    pj = jm.predict(ToyData(seed=3), batch_size=64)
    assert pt[0].dtype == np.float32
    np.testing.assert_allclose(pt[0], pj[0], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("jit", [False, True])
def test_o2_fit_matches_reference(jit):
    """O2 ``decorate`` then ``prepare(amp_configs={"level": "O2"})``.
    Before training, ``predict`` is bitwise the reference network under
    its O2 ``auto_cast``, and within 2e-2 of the reference's ``predict``,
    which promotes the products to f32 (ROADMAP, stated differences).
    ``fit`` over 2 epochs and ``evaluate`` then hold the reference's O2
    loop (eager) within the O1 loss curve's tolerance (2e-2 absolute,
    ``tests/test_torch_training.py``); the parameters stay bf16 with f32
    master weights."""
    jm, tmod = _pair(jit, metrics=False, amp="O2", ref_jit=False)
    pt = tmod.predict(ToyData(seed=3), batch_size=64)[0]
    with paddle.amp.auto_cast(level="O2"):
        pa = jm.network(paddle.to_tensor(ToyData(seed=3).x))
    assert pt.dtype == np.float32
    np.testing.assert_array_equal(pt, np.asarray(pa.astype("float32")
                                                 .numpy()))
    np.testing.assert_allclose(
        pt, np.asarray(jm.predict(ToyData(seed=3), batch_size=64)[0],
                       np.float32), rtol=0, atol=2e-2)
    hj = jm.fit(_loader(rio, ToyData()), eval_data=ToyData(seed=1),
                batch_size=32, epochs=2, verbose=0)
    ht = tmod.fit(_loader(tio, ToyData()), eval_data=ToyData(seed=1),
                  batch_size=32, epochs=2, verbose=0)
    assert len(ht.history) == len(hj.history) == 2
    for a, b in zip(ht.history, hj.history):
        assert set(a) == set(b) == {"loss", "eval_loss"}
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=2e-2,
                                       err_msg=k)
    np.testing.assert_allclose(
        tmod.evaluate(ToyData(seed=2), batch_size=32, verbose=0)["loss"],
        jm.evaluate(ToyData(seed=2), batch_size=32, verbose=0)["loss"],
        rtol=0, atol=2e-2)
    masters = tmod._optimizer._accumulators["master_weight"]
    for p in tmod.network.parameters():
        assert p.dtype == torch.bfloat16
        assert masters[id(p)].dtype == torch.float32


def test_train_batch_metric_names_and_counts():
    jm, tmod = _pair(False)
    for m in (jm, tmod):
        m._metrics = [(rm if m is jm else tm).Accuracy(topk=(1, 2))]
    rng = np.random.RandomState(0)
    x = rng.randn(32, 4).astype("float32")
    y = rng.randint(0, 2, (32,)).astype("int64")
    want = jm.train_batch([paddle.to_tensor(x)], [paddle.to_tensor(y)])
    got = tmod.train_batch([x], [y])
    _close_logs(got, want)
    assert tmod._metrics[0].count == [32, 32]


def test_early_stopping_stops_at_the_references_epoch():
    stops = []
    for mod, m in zip((rh, th), _pair(False)):
        es = mod.EarlyStopping(monitor="loss", patience=1, min_delta=0.05)
        data = _loader(rio if mod is rh else tio, ToyData())
        hist = m.fit(data, epochs=12, verbose=0, callbacks=[es])
        stops.append((es.stopped_epoch, len(hist.history), es.wait))
    assert stops[0] == stops[1] and stops[0][0] is not None
    es = th.EarlyStopping(monitor="acc")
    assert es.mode == "max"


def test_lr_scheduler_callback_steps_as_the_reference():
    sched = (paddle.optimizer.lr.StepDecay(0.03, step_size=2, gamma=0.5),
             lr.StepDecay(0.03, step_size=2, gamma=0.5))
    jm, tmod = _pair(False, sched=sched, metrics=False)
    seen = {}
    for key, m, mod in (("ref", jm, rh), ("port", tmod, th)):
        class Rec(mod.Callback):
            def on_train_batch_begin(self, step, logs=None):
                seen.setdefault(key, []).append(
                    self.model._optimizer.get_lr())
        m.fit(_loader(rio if mod is rh else tio, ToyData(n=96)), epochs=2,
              verbose=0, callbacks=[Rec(), mod.LRScheduler(by_step=True)])
    assert seen["port"] == seen["ref"] and len(seen["port"]) == 6


def test_save_load_round_trip_is_bitwise(tmp_path):
    _, tmod = _pair(False)
    tmod.fit(_loader(tio, ToyData()), epochs=1, verbose=0,
             save_dir=str(tmp_path))
    assert os.path.exists(str(tmp_path / "final.pdparams"))
    assert os.path.exists(str(tmp_path / "0.pdopt"))
    _, other = _pair(False)
    other.fit(_loader(tio, ToyData(seed=4)), epochs=1, verbose=0)
    other.load(str(tmp_path / "final"))
    for (n, a), b in zip(tmod.network.state_dict().items(),
                         other.network.state_dict().values()):
        assert torch.equal(a, b), n
    sa, sb = tmod._optimizer.state_dict(), other._optimizer.state_dict()
    for k in sa:
        if isinstance(sa[k], torch.Tensor):
            assert torch.equal(sa[k], sb[k]), k
    np.testing.assert_array_equal(
        tmod.predict(ToyData(seed=3), batch_size=64)[0],
        other.predict(ToyData(seed=3), batch_size=64)[0])


def test_checkpoint_callback_saves_and_restores(tmp_path):
    """Through ``fit``: a commit every 2 steps and one at the end; the next
    ``fit`` restores the latest step in place before its first batch. The
    steps saved and restored equal the reference callback's on the same
    loop, and the restored state is the saved one, bitwise."""
    got = {}
    for key, mod, iom, m in (("ref", rh, rio, _pair(False)[0]),
                             ("port", th, tio, _pair(False)[1])):
        root = str(tmp_path / key)
        cb = mod.CheckpointCallback(dir=root, save_freq_steps=2,
                                    async_save=False, on_preemption=False)
        m.fit(_loader(iom, ToyData(n=96)), epochs=1, verbose=0,
              callbacks=[cb])
        saved = {k: np.array(v.detach().numpy() if key == "port"
                             else np.asarray(v._data))
                 for k, v in m.network.state_dict().items()}
        fresh = _pair(False)[0 if key == "ref" else 1]
        cb2 = mod.CheckpointCallback(dir=root, save_freq_steps=2,
                                     async_save=False, on_preemption=False)
        seen = {}

        class Probe(mod.Callback):
            def on_train_begin(self, logs=None):
                seen.update({k: np.array(
                    v.detach().numpy() if key == "port"
                    else np.asarray(v._data))
                    for k, v in self.model.network.state_dict().items()})
        fresh.fit(_loader(iom, ToyData(n=32)), epochs=1, verbose=0,
                  callbacks=[cb2, Probe()])
        for k, v in saved.items():
            np.testing.assert_array_equal(seen[k], v, err_msg=k)
        got[key] = (cb.global_step, cb2.restored_step, cb2.global_step,
                    cb2.manager.committed_steps())
    assert got["port"] == got["ref"] == (3, 2, 4, [1, 2, 3])
    with pytest.raises(ValueError):
        th.CheckpointCallback()


def test_metrics_callback_reads_the_analytic_flops():
    """Stated difference: the port's compile watcher publishes no
    ``paddle_tpu_xla_program_flops`` gauge, so MFU comes from the
    analytic count (``flops_per_sample`` or ``model_summary.flops``)."""
    reg = om.MetricsRegistry()
    cb = th.MetricsCallback(batch_size=32, input_size=(1, 4),
                            peak_flops=1e12, registry=reg,
                            sample_memory=False)
    _, tmod = _pair(True)
    tmod.fit(_loader(tio, ToyData()), epochs=1, verbose=0, callbacks=[cb])
    assert cb.flops_per_sample == th.flops(tmod.network, (1, 4)) == \
        2 * (4 * 16 + 16 * 2)
    assert cb._watched_step_flops() is None
    if om.enabled():
        assert cb._steps.value == 4
        assert 0.0 < cb._mfu.value <= 1.0
        assert cb._loss.value > 0 and cb._ips.value > 0


def test_summary_and_flops_match_reference(capsys):
    jnet = pnn.Sequential(pnn.Conv2D(3, 8, 3, padding=1),
                          pnn.BatchNorm2D(8), pnn.ReLU(),
                          pnn.Conv2D(8, 8, 3, padding=1, groups=8),
                          pnn.MaxPool2D(2), pnn.AdaptiveAvgPool2D(1),
                          pnn.Flatten(), pnn.Linear(8, 4))
    tnet = torch.nn.Sequential(torch.nn.Conv2d(3, 8, 3, padding=1),
                               torch.nn.BatchNorm2d(8), torch.nn.ReLU(),
                               torch.nn.Conv2d(8, 8, 3, padding=1, groups=8),
                               torch.nn.MaxPool2d(2),
                               torch.nn.AdaptiveAvgPool2d(1),
                               torch.nn.Flatten(), torch.nn.Linear(8, 4))
    assert th.flops(tnet, (2, 3, 10, 10)) == \
        paddle.flops(jnet, (2, 3, 10, 10))
    tnet.train()
    info = th.summary(tnet, (1, 3, 10, 10))
    assert info == paddle.summary(jnet, (1, 3, 10, 10))
    assert tnet.training
    assert all(not m._forward_hooks for m in tnet.modules())
    out = capsys.readouterr().out
    assert "Conv2d" in out and "Total params" in out
    custom = th.flops(tnet, (1, 3, 10, 10),
                      custom_ops={torch.nn.Linear: lambda l, i, o: 123})
    assert custom == th.flops(tnet, (1, 3, 10, 10)) - 2 * 8 * 4 + 123
    _, tmod = _pair(False)
    assert tmod.summary()["total_params"] == 4 * 16 + 16 + 16 * 2 + 2


def test_flops_counts_the_ports_rmsnorm():
    from paddle_tpu_torch.models.llama import RMSNorm
    net = torch.nn.Sequential(torch.nn.Linear(8, 8), RMSNorm(8))
    assert th.flops(net, (3, 8)) == 2 * 3 * 8 * 8 + 2 * 3 * 8


def test_hub_loads_a_local_repo(tmp_path):
    (tmp_path / "hubconf.py").write_text(
        "dependencies = ['numpy']\n"
        "def tiny(scale=1):\n"
        "    '''A tiny entrypoint.'''\n"
        "    return {'scale': scale}\n"
        "def _hidden():\n"
        "    pass\n")
    d = str(tmp_path)
    assert th.hub.list(d) == paddle.hub.list(d) == ["tiny"]
    assert th.hub.help(d, "tiny") == paddle.hub.help(d, "tiny")
    assert th.hub.load(d, "tiny", scale=3) == {"scale": 3}
    with pytest.raises(RuntimeError):
        th.hub.load(d, "tiny", source="github")
    with pytest.raises(RuntimeError):
        th.hub.load(d, "missing")


def test_prepare_checks_and_input_spec():
    _, tmod = _pair(False)
    opt = tmod._optimizer
    with pytest.raises(TypeError):
        tmod.prepare(loss=3)
    with pytest.raises(TypeError):
        tmod.prepare(metrics=[object()])
    spec = th.Input([None, 4], "float32", "x")
    assert (spec.shape, spec.dtype, spec.name) == ([None, 4], "float32", "x")
    log = th.ProgBarLogger(log_freq=1, verbose=2)
    tmod.prepare(optimizer=opt, loss=_ce)
    tmod.fit(_loader(tio, ToyData(n=64)), epochs=1, callbacks=[log])
