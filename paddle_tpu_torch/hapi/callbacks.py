"""hapi callbacks (port of the reference package's ``hapi/callbacks.py``,
a copy on the port's registry, checkpoint manager and faults):
``Callback``, ``CallbackList``, ``ProgBarLogger``, ``History``,
``ModelCheckpoint``, ``EarlyStopping``, ``LRScheduler``,
``MetricsCallback``, ``CheckpointCallback`` and ``config_callbacks``.

``MetricsCallback`` peeks the reference's compiled-program FLOPs gauge
(``paddle_tpu_xla_program_flops{callable}``), which the port's compile
watcher does not publish (a CUDA graph carries no cost analysis), so its
MFU reads the analytic count: ``flops_per_sample``, or
``model_summary.flops`` of ``input_size`` (ROADMAP, stated differences).
``CheckpointCallback`` saves on ``PADDLE_TRAINER_ID``'s rank, else rank 0.
"""

from __future__ import annotations

import os
import time

import numpy as np

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "EarlyStopping",
           "LRScheduler", "History", "MetricsCallback",
           "CheckpointCallback", "config_callbacks"]


class Callback:
    """Base callback: every hook is a no-op (reference callbacks.py:66)."""

    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params or {}

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = list(callbacks)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def call(*args, **kwargs):
                for c in self.callbacks:
                    getattr(c, name)(*args, **kwargs)
            return call
        raise AttributeError(name)


class ProgBarLogger(Callback):
    """Per-epoch textual progress (reference callbacks.py ProgBarLogger)."""

    def __init__(self, log_freq=10, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        self._start = time.time()
        if self.verbose and self.params.get("epochs"):
            print(f"Epoch {epoch + 1}/{self.params['epochs']}")

    def _fmt(self, logs):
        return " - ".join(
            f"{k}: {np.asarray(v).reshape(-1)[0]:.4f}"
            if isinstance(v, (int, float, np.generic, np.ndarray, list))
            else f"{k}: {v}" for k, v in (logs or {}).items())

    def on_train_batch_end(self, step, logs=None):
        if self.verbose > 1 and step % self.log_freq == 0:
            print(f"step {step}/{self.steps or '?'} - {self._fmt(logs)}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._start
            print(f"epoch {epoch + 1} done in {dt:.1f}s - "
                  f"{self._fmt(logs)}")

    def on_eval_end(self, logs=None):
        if self.verbose:
            print(f"Eval - {self._fmt(logs)}")


class History(Callback):
    """Records per-epoch logs (keras-style convenience)."""

    def on_train_begin(self, logs=None):
        self.history = []

    def on_epoch_end(self, epoch, logs=None):
        self.history.append(dict(logs or {}))


class ModelCheckpoint(Callback):
    """Save every ``save_freq`` epochs (reference ModelCheckpoint)."""

    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and (epoch + 1) % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class EarlyStopping(Callback):
    """Stop when a monitored metric stops improving (reference
    EarlyStopping)."""

    def __init__(self, monitor="loss", mode="auto", patience=0,
                 min_delta=0, baseline=None, save_best_model=False,
                 save_dir=None):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.save_best_model = save_best_model
        self.save_dir = save_dir
        self.wait = 0
        self.best = None
        self.stopped_epoch = None

    def _better(self, cur, best):
        if self.mode == "max":
            return cur > best + self.min_delta
        return cur < best - self.min_delta

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        # prefer the validation metric: fit prefixes eval logs with
        # "eval_" (the reference feeds EarlyStopping raw eval logs)
        cur = logs.get(f"eval_{self.monitor}", logs.get(self.monitor))
        if cur is None:
            return
        cur = float(np.asarray(cur).reshape(-1)[0])
        if self.best is None and self.baseline is not None:
            self.best = float(self.baseline)  # must beat the baseline
        if self.best is None or self._better(cur, self.best):
            self.best = cur
            self.wait = 0
            if self.save_best_model and self.save_dir:
                self.model.save(os.path.join(self.save_dir, "best_model"))
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped_epoch = epoch
                self.model.stop_training = True


class MetricsCallback(Callback):
    """Publishes training-loop signals into the observability registry
    (:mod:`paddle_tpu_torch.observability`): per-step wall time,
    instantaneous ips, and an MFU estimate.

    - ``batch_size``: samples per step; enables the ``train_ips`` gauge.
    - ``flops_per_sample``: forward FLOPs for ONE sample. If omitted but
      ``input_size`` is given (a full input shape with batch dim 1, e.g.
      ``(1, 4)``), it is estimated at ``on_train_begin`` via
      ``hapi.model_summary.flops``.
    - ``peak_flops``: the accelerator's peak FLOP/s; enables the
      ``train_mfu`` gauge as ``train_flops_multiplier * flops_per_sample
      * batch_size / step_time / peak_flops`` (the multiplier defaults
      to 3.0 — forward + backward ~= 2x forward).
    - ``flops_watch`` (default ``"hapi.train_step"``): when the compile
      watcher holds a ``cost_analysis`` FLOPs gauge for that callable
      (``paddle_tpu_xla_program_flops{callable=...}``), MFU reads the
      COMPILED step's exact FLOPs (forward + backward + update, per
      step, already batch-inclusive) instead of the ``model_summary``
      analytic count — so fused-loss and MoE models, whose hooked
      forward under-/over-counts, report honest MFU. ``None`` disables
      the gauge read (analytic accounting only). The port's compile
      watcher publishes no such gauge, so the read finds none and the
      analytic count is used.
    - ``sample_memory`` (default True): per-step device-memory gauges
      (``paddle_tpu_device_bytes_in_use`` / ``..._live_array_bytes``,
      see ``observability.compile_watch.sample_device_memory``) plus a
      rate-limited flight-recorder metrics snapshot — host metadata
      walks only, no device sync.

    Metric names: ``train_steps_total``, ``train_step_seconds``,
    ``train_ips``, ``train_mfu``, ``train_loss``.
    """

    #: step-time buckets: 1ms .. 60s
    STEP_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                    0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

    def __init__(self, batch_size=None, flops_per_sample=None,
                 input_size=None, peak_flops=None,
                 train_flops_multiplier=3.0, registry=None,
                 sample_memory=True, flops_watch="hapi.train_step"):
        super().__init__()
        from ..observability import metrics as om
        reg = registry if registry is not None else om.default_registry()
        self.sample_memory = bool(sample_memory)
        self._registry = registry
        self.flops_watch = flops_watch
        self.batch_size = batch_size
        self.flops_per_sample = flops_per_sample
        self.input_size = input_size
        self.peak_flops = peak_flops
        self.train_flops_multiplier = float(train_flops_multiplier)
        self._steps = reg.counter("train_steps_total",
                                  "optimizer steps taken")
        self._step_time = reg.histogram("train_step_seconds",
                                        "wall time per train step",
                                        buckets=self.STEP_BUCKETS)
        self._ips = reg.gauge("train_ips",
                              "instantaneous samples per second")
        self._mfu = reg.gauge("train_mfu",
                              "model FLOPs utilization estimate (0..1)")
        self._loss = reg.gauge("train_loss", "last train-step loss")
        self._t0 = None

    def on_train_begin(self, logs=None):
        if self.flops_per_sample is None and self.input_size is not None:
            from .model_summary import flops as _flops
            net = getattr(self.model, "network", self.model)
            try:
                self.flops_per_sample = _flops(net, self.input_size)
            except Exception:
                self.flops_per_sample = None   # un-hookable nets: no MFU

    def _watched_step_flops(self):
        """FLOPs of the last program the compile watcher recorded for
        ``flops_watch`` — the cost_analysis gauge, peeked so an absent
        watch (METRICS=0, jit=False, un-analyzed backend) never mints an
        empty gauge child; None falls back to the analytic count."""
        if not self.flops_watch:
            return None
        from ..observability import metrics as om
        reg = self._registry if self._registry is not None \
            else om.default_registry()
        fam = reg.get("paddle_tpu_xla_program_flops")
        if fam is None:
            return None
        child = fam.peek(self.flops_watch)
        if child is None:
            return None
        v = child.value
        return v if v and v > 0 else None

    def on_train_batch_begin(self, step, logs=None):
        self._t0 = time.perf_counter()

    def on_train_batch_end(self, step, logs=None):
        if self._t0 is None:
            return
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self._steps.inc()
        self._step_time.observe(dt)
        loss = (logs or {}).get("loss")
        if loss is not None:
            self._loss.set(float(np.asarray(loss).reshape(-1)[0]))
        if self.batch_size and dt > 0:
            self._ips.set(self.batch_size / dt)
        if self.peak_flops and dt > 0:
            step_flops = self._watched_step_flops()
            if step_flops:
                # exact per-step FLOPs of the compiled program
                # (cost_analysis counts fwd+bwd+update, whole batch) —
                # needs no batch_size: the gauge is batch-inclusive
                self._mfu.set(step_flops / dt / self.peak_flops)
            elif self.flops_per_sample and self.batch_size:
                achieved = (self.train_flops_multiplier
                            * self.flops_per_sample
                            * self.batch_size / dt)
                self._mfu.set(achieved / self.peak_flops)
        if self.sample_memory:
            from ..observability import compile_watch, flight_recorder
            if compile_watch.enabled():
                compile_watch.sample_device_memory(self._registry,
                                                   min_interval=1.0)
                flight_recorder.periodic_snapshot()


class CheckpointCallback(Callback):
    """Fault-tolerant, step-granular checkpointing through
    :class:`~paddle_tpu_torch.distributed.checkpoint_manager
    .CheckpointManager` — the training-side half of the elastic recovery
    loop (reference: `fleet/elastic/manager.py` checkpoint-and-relaunch;
    compare :class:`ModelCheckpoint`, which writes per-epoch and not
    atomically).

    - every ``save_freq_steps`` optimizer steps the network state is
      committed atomically; with ``async_save`` the fit loop is blocked
      only for the device-to-host snapshot.
    - on ``on_train_begin`` the latest committed step is restored in
      place (parameters AND the step counter), so a relaunched worker
      continues at ``restored_step + 1``. The checkpoint root comes
      from ``dir`` or ``$PADDLE_TPU_RESUME_DIR`` — what
      ``launch_elastic(resume_dir=...)`` exports to every generation.
    - on SIGTERM (a preemption notice / the elastic supervisor's
      teardown) the handler only sets a flag; the emergency save runs
      at the NEXT batch boundary — a signal landing mid-optimizer-step
      would otherwise snapshot half-updated parameters into a
      checksum-valid checkpoint — then the process exits.
    - only ``save_rank`` (default 0) commits: every worker of a
      generation receives the same ``PADDLE_TPU_RESUME_DIR``, and
      concurrent commits to one directory would tear each other's
      saves. All ranks restore. (``save_rank=None`` saves everywhere —
      only for distinct per-rank directories.)

    ``global_step`` counts completed optimizer steps monotonically
    across epochs; restore refreshes weights and that counter, while
    epoch/dataloader positioning stays the caller's concern.
    """

    def __init__(self, dir=None, save_freq_steps=100, max_to_keep=5,
                 async_save=True, restore=True, on_preemption=True,
                 manager=None, save_rank=0):
        super().__init__()
        if manager is None:
            from ..distributed.checkpoint_manager import (
                CheckpointManager, resume_dir_from_env)
            root = dir or resume_dir_from_env()
            if not root:
                raise ValueError(
                    "CheckpointCallback needs dir=..., manager=..., or "
                    "$PADDLE_TPU_RESUME_DIR (set by "
                    "launch_elastic(resume_dir=...))")
            manager = CheckpointManager(root, max_to_keep=max_to_keep,
                                        async_save=async_save)
        self.manager = manager
        self.save_freq_steps = int(save_freq_steps)
        self.restore = restore
        self.on_preemption = on_preemption
        self.save_rank = save_rank
        self.global_step = 0
        self.restored_step = None
        self._dirty = False
        self._preempt_signum = None
        self._prev_sigterm = None

    def _net(self):
        return getattr(self.model, "network", self.model)

    def _state(self):
        return {"model": self._net().state_dict()}

    def _is_saver(self):
        if self.save_rank is None:
            return True
        rank = os.environ.get("PADDLE_TRAINER_ID", "0")
        return int(rank) == int(self.save_rank)

    def on_train_begin(self, logs=None):
        if self.restore:
            # state_dict() returns the live parameter Tensors, so
            # restore_latest fills the network in place
            step = self.manager.restore_latest(self._state())
            if step is not None:
                self.restored_step = step
                self.global_step = step + 1
        if self.on_preemption:
            import signal
            self._prev_sigterm = signal.signal(signal.SIGTERM,
                                               self._on_preempt_signal)

    def _on_preempt_signal(self, signum, frame):
        # flag only: a mid-optimizer-step save would commit parameters
        # half old-step, half new-step — consistent-looking on disk,
        # corresponding to no step boundary. The next batch boundary
        # saves and exits.
        self._preempt_signum = signum

    def on_train_batch_end(self, step, logs=None):
        from ..testing import faults as _faults
        _faults.fire("train.step", step=self.global_step)
        done = self.global_step          # the step just completed
        self.global_step += 1
        self._dirty = True
        saver = self._is_saver()
        if saver and (done + 1) % self.save_freq_steps == 0:
            self.manager.save(self._state(), done)
            self._dirty = False
        if self._preempt_signum is not None:
            if saver:
                self.manager._m_preempt.inc()
                try:
                    self.manager.save(self._state(), done,
                                      blocking=True)
                except Exception:
                    pass             # exiting anyway; already counted
            os._exit(128 + self._preempt_signum)

    def on_train_end(self, logs=None):
        if self._is_saver() and self._dirty and self.global_step > 0:
            self.manager.save(self._state(), self.global_step - 1,
                              blocking=True)
            self._dirty = False
        self.manager.wait()
        if self.on_preemption and self._prev_sigterm is not None:
            import signal
            signal.signal(signal.SIGTERM, self._prev_sigterm)
            self._prev_sigterm = None


class LRScheduler(Callback):
    """Steps the optimizer's LRScheduler (reference LRScheduler callback:
    by default once per epoch)."""

    def __init__(self, by_step=False, by_epoch=True):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        from ..optimizer.lr import LRScheduler as Sched
        lr = getattr(self.model._optimizer, "_learning_rate", None)
        return lr if isinstance(lr, Sched) else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()


def config_callbacks(callbacks, model, epochs=None, steps=None,
                     log_freq=10, verbose=2, save_freq=1, save_dir=None,
                     metrics=None):
    cbs = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbs):
        cbs.insert(0, ProgBarLogger(log_freq, verbose=verbose))
    if not any(isinstance(c, LRScheduler) for c in cbs):
        cbs.append(LRScheduler())
    if save_dir and not any(isinstance(c, ModelCheckpoint) for c in cbs):
        cbs.append(ModelCheckpoint(save_freq, save_dir))
    if not any(isinstance(c, History) for c in cbs):
        cbs.append(History())
    clist = CallbackList(cbs)
    clist.set_model(model)
    clist.set_params({"epochs": epochs, "steps": steps,
                      "verbose": verbose, "metrics": metrics or []})
    return clist
