"""hapi: the high-level ``Model.fit`` training API (port of the reference
package's ``hapi``): ``Model``, ``Input``, the callbacks, ``summary``,
``flops`` and ``hub``.

``prepare(..., jit=True)`` (the default) wraps the train step, forward,
loss, ``backward``, ``opt.step()`` and ``opt.clear_grad()``, in
:func:`paddle_tpu_torch.jit.to_static` (``name="hapi.train_step"``): one
CUDA graph per input signature on the card, its first call eager, its
second the capture. ``amp_configs`` (``auto_cast``'s keyword arguments)
wraps the network's forward in ``auto_cast``; the loss runs outside it,
as in the reference. Batches arrive from the ``DataLoader`` as host
arrays and go to the network's device once a step. ``eval_batch`` and
``predict_batch`` run eagerly under ``torch.no_grad()`` and outside
``auto_cast``, as in the reference, unless the network holds 16-bit
parameters (after O2 ``decorate``): torch's products take no mixed
16-bit / f32 operands, where the reference's promote them to f32, so
there they run under the training ``auto_cast`` (ROADMAP, stated
differences). Metrics stream on the host from each step's outputs.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from .. import jit as jit_mod
from ..metric import Metric
from . import hub  # noqa: F401
from .model_summary import _device, flops, summary
from .callbacks import (CheckpointCallback, Callback, EarlyStopping, History,
                        LRScheduler, MetricsCallback, ModelCheckpoint,
                        ProgBarLogger, config_callbacks)

__all__ = ["Model", "Input", "Callback", "ProgBarLogger",
           "ModelCheckpoint", "EarlyStopping", "LRScheduler", "History",
           "MetricsCallback", "CheckpointCallback", "summary", "flops"]


class Input:
    """Shape/dtype spec placeholder (the reference's ``Input``); kept for
    the API, a step's signature comes from its tensors."""

    def __init__(self, shape=None, dtype="float32", name=None):
        self.shape = shape
        self.dtype = dtype
        self.name = name


def _to_tensor(x, device):
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


def _as_batch(batch):
    """DataLoader batches arrive as (inputs..., label) tuples/lists."""
    if isinstance(batch, (list, tuple)):
        if len(batch) == 1:
            return [batch[0]], []
        return list(batch[:-1]), [batch[-1]]
    return [batch], []


def _listify(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


class Model:
    """High-level trainer wrapping an ``nn.Module`` (the reference's
    ``Model``)."""

    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._jit = True
        self._amp = None
        self._train_step = None
        self._n_labels = 0
        self.stop_training = False

    # -- setup --------------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None, jit=True,
                amp_configs=None):
        self._optimizer = optimizer
        if loss is not None and not callable(loss):
            raise TypeError("loss must be callable (a module or function)")
        self._loss = loss
        metrics = metrics or []
        for m in metrics:
            if not isinstance(m, Metric):
                raise TypeError(f"metrics must be paddle.metric.Metric, "
                                f"got {type(m)}")
        self._metrics = metrics
        self._jit = jit
        self._amp = amp_configs or None
        self._train_step = None
        return self

    def _amp_region(self):
        from .. import amp as amp_pkg
        if self._amp:
            return amp_pkg.auto_cast(**self._amp)
        return contextlib.nullcontext()

    def _eval_amp_region(self):
        """The training ``auto_cast`` where the network holds 16-bit
        parameters, else none (see the module's docstring)."""
        if any(p.dtype in (torch.float16, torch.bfloat16)
               for p in self.network.parameters()):
            return self._amp_region()
        return contextlib.nullcontext()

    # -- single-batch ops ---------------------------------------------------
    def _compute_loss(self, outputs, labels):
        if self._loss is None:
            raise RuntimeError("prepare() with a loss before training")
        return self._loss(*_listify(outputs), *labels)

    def _make_train_step(self):
        net, opt = self.network, self._optimizer

        def step(*args):
            n_label = self._n_labels
            if n_label:
                inputs, labels = args[:-n_label], args[-n_label:]
            else:
                inputs, labels = args, ()
            with self._amp_region():
                outputs = net(*inputs)
            loss = self._compute_loss(outputs, list(labels))
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss, outputs

        if self._jit:
            return jit_mod.to_static(step, state=[net, opt],
                                     name="hapi.train_step")
        return step

    def _tensors(self, xs):
        dev = _device(self.network)
        return [_to_tensor(x, dev) for x in xs]

    def train_batch(self, inputs, labels=None):
        """One optimizer step; returns ``{'loss': float, <metric>:
        value}``."""
        if self._train_step is None:
            self._n_labels = len(labels or [])
            self._train_step = self._make_train_step()
        inputs = self._tensors(_listify(inputs))
        labels = self._tensors(labels or [])
        self.network.train()
        loss, outputs = self._train_step(*inputs, *labels)
        logs = {"loss": float(loss.detach())}
        for m in self._metrics:
            _metric_update(m, outputs, labels)
            logs.update(_metric_logs(m))
        return logs

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        inputs = self._tensors(_listify(inputs))
        labels = self._tensors(labels or [])
        self.network.eval()
        with self._eval_amp_region():
            outputs = self.network(*inputs)
        logs = {}
        if self._loss is not None and labels:
            logs["loss"] = float(self._compute_loss(outputs, labels))
        for m in self._metrics:
            _metric_update(m, outputs, labels)
            logs.update(_metric_logs(m))
        return logs

    @torch.no_grad()
    def predict_batch(self, inputs):
        inputs = self._tensors(_listify(inputs))
        self.network.eval()
        with self._eval_amp_region():
            return self.network(*inputs)

    # -- loops --------------------------------------------------------------
    def _loader(self, data, batch_size, shuffle, drop_last=False,
                num_workers=0):
        from ..io import DataLoader
        if data is None:
            return None
        if isinstance(data, DataLoader):
            return data
        return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                          drop_last=drop_last, num_workers=num_workers)

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1,
            verbose=2, drop_last=False, shuffle=True, num_workers=0,
            callbacks=None):
        """Trains with per-epoch evaluation and callback hooks; returns
        the ``History`` callback (the reference's ``fit``)."""
        loader = self._loader(train_data, batch_size, shuffle,
                              drop_last=drop_last,
                              num_workers=num_workers)
        eval_loader = self._loader(eval_data, batch_size, False,
                                   num_workers=num_workers)
        try:
            steps = len(loader)
        except TypeError:
            steps = None
        cbks = config_callbacks(
            callbacks, self, epochs=epochs, steps=steps,
            log_freq=log_freq, verbose=verbose, save_freq=save_freq,
            save_dir=save_dir, metrics=_metric_names(self._metrics))
        self.stop_training = False
        cbks.on_train_begin()
        logs = {}
        for epoch in range(epochs):
            cbks.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            for step, batch in enumerate(loader):
                cbks.on_train_batch_begin(step)
                inputs, labels = _as_batch(batch)
                logs = self.train_batch(inputs, labels)
                cbks.on_train_batch_end(step, logs)
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self.evaluate(eval_loader, verbose=0)
                logs = dict(logs)
                logs.update({f"eval_{k}": v for k, v in eval_logs.items()})
            cbks.on_epoch_end(epoch, logs)
            if self.stop_training:
                break
        cbks.on_train_end(logs)
        for c in cbks.callbacks:
            if isinstance(c, History):
                return c
        return None

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None):
        loader = self._loader(eval_data, batch_size, False,
                              num_workers=num_workers)
        cbks = config_callbacks(callbacks, self, verbose=verbose,
                                metrics=_metric_names(self._metrics))
        for m in self._metrics:
            m.reset()
        cbks.on_eval_begin()
        logs, losses, weights = {}, [], []
        for step, batch in enumerate(loader):
            cbks.on_eval_batch_begin(step)
            inputs, labels = _as_batch(batch)
            logs = self.eval_batch(inputs, labels)
            if "loss" in logs:
                losses.append(logs["loss"])
                weights.append(len(inputs[0]))  # sample-weighted mean
            cbks.on_eval_batch_end(step, logs)
        if losses:
            logs["loss"] = float(np.average(losses, weights=weights))
        for m in self._metrics:
            logs.update(_metric_logs(m))
        cbks.on_eval_end(logs)
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=True, verbose=1, callbacks=None):
        loader = self._loader(test_data, batch_size, False,
                              num_workers=num_workers)
        outs = []
        for batch in loader:
            inputs, _ = _as_batch(batch)
            out = self.predict_batch(inputs)
            outs.append(_host(out) if isinstance(out, torch.Tensor)
                        else out)
        if stack_outputs and outs and isinstance(outs[0], np.ndarray):
            return [np.concatenate(outs, axis=0)]
        return outs

    # -- persistence --------------------------------------------------------
    def save(self, path, training=True):
        from ..framework.io import save
        save(self.network.state_dict(keep_vars=True), path + ".pdparams")
        if training and self._optimizer is not None \
                and getattr(self._optimizer, "state_dict", None):
            save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from ..framework.io import load
        state = load(path + ".pdparams")
        self.network.load_state_dict(state, strict=not skip_mismatch)
        if not reset_optimizer and self._optimizer is not None \
                and os.path.exists(path + ".pdopt"):
            opt_state = load(path + ".pdopt")
            if getattr(self._optimizer, "set_state_dict", None):
                self._optimizer.set_state_dict(opt_state)

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        n = sum(int(np.prod(p.shape)) for p in self.network.parameters())
        lines = [f"Model: {type(self.network).__name__}",
                 f"Total params: {n:,}"]
        print("\n".join(lines))
        return {"total_params": n}


def _host(t):
    """A tensor as a host numpy array (16-bit floats widened to f32)."""
    t = t.detach()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.cpu().numpy()


def _metric_names(metrics):
    out = []
    for m in metrics:
        n = m.name()
        out.extend([n] if isinstance(n, str) else list(n))
    return out


def _metric_update(m, outputs, labels):
    """Feed one batch to a metric. ``compute()`` may return a single
    array or a tuple; only a tuple is splatted into ``update()``."""
    pred = outputs[0] if isinstance(outputs, (list, tuple)) else outputs
    res = m.compute(pred, *labels)
    if isinstance(res, tuple):
        m.update(*res)
    else:
        m.update(res)


def _metric_logs(m):
    names = m.name()
    vals = m.accumulate()
    if isinstance(names, str):
        return {names: vals}
    return dict(zip(names, vals if isinstance(vals, (list, tuple))
                    else [vals]))

