"""Dynamic loss scaling (port of the reference package's
``amp/grad_scaler.py``): ``GradScaler`` / ``AmpScaler`` with ``scale``,
``unscale_``, ``step``, ``update``, ``minimize``, ``state_dict`` /
``load_state_dict``, and the ``amp_found_inf_total`` /
``amp_scale_backoff_total`` counters.

bf16 training needs no loss scaling; float16 does. The scale, the growth
tracker and the count of bad steps are 0-d device tensors updated IN
PLACE (``copy_`` of a ``torch.where``), never rebound: a compiled step's
CUDA graph bakes their addresses, and ``jit.to_static`` finds them
through ``__state_tensors__``. They live on the host until the first
``scale`` or ``unscale_`` moves them to the loss's or the gradients'
device, outside any capture.

Two ways to skip an overflow step, as in the reference:

- **eager**, the hard skip: ``step`` reads the overflow flag on the host
  and does not call ``optimizer.step()``;
- **masked**, inside a compiled step (``jit.to_static`` after its eager
  warm-up: the capture call's real step, every replay, and on the CPU
  every call on the static buffers) and under any CUDA-graph capture,
  where the flag cannot be read: the gradients become zeros by a select
  (not a multiply: ``inf * 0`` is NaN) and the optimizer's device
  learning rate is selected to 0 on overflow. Parameters (and decoupled
  weight decay) stay bitwise unchanged; the moments decay toward zero on
  the skipped step, as the reference's traced step does. The counters'
  host read is skipped there, as the reference skips it for a traced
  value.
"""

from __future__ import annotations

import torch

from ..observability import metrics as _om

__all__ = ["GradScaler", "AmpScaler"]


def _masked(device):
    """True where the overflow flag cannot be read on the host: inside a
    compiled step, or while this thread's stream is capturing."""
    from .. import jit
    if jit.in_compiled_step():
        return True
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 16,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = bool(enable)
        self._incr_ratio = float(incr_ratio)
        self._decr_ratio = float(decr_ratio)
        self._incr_every_n_steps = int(incr_every_n_steps)
        self._decr_every_n_nan_or_inf = int(decr_every_n_nan_or_inf)
        self._use_dynamic = bool(use_dynamic_loss_scaling)
        self._scale = torch.tensor(float(init_loss_scaling),
                                   dtype=torch.float32)
        self._growth = torch.zeros((), dtype=torch.int32)
        self._bad = torch.zeros((), dtype=torch.int32)
        self._found_inf = None        # set by unscale_
        self._unscaled = set()        # optimizers already unscaled this step
        # counters observe only on the eager path: a masked step's flag is
        # never read on the host
        self._m_found_inf = _om.counter(
            "amp_found_inf_total", "steps with non-finite gradients")
        self._m_backoff = _om.counter(
            "amp_scale_backoff_total", "loss-scale decreases")

    # -- to_static integration ---------------------------------------------
    def __state_tensors__(self):
        return [self._scale, self._growth, self._bad]

    def _place(self, device):
        """Move the state to ``device`` once, keeping the tensor objects
        (their storage is swapped, outside any capture)."""
        if self._scale.device == device:
            return
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "the GradScaler's state would move to the card under a "
                "CUDA-graph capture: run one eager step first")
        for t in self.__state_tensors__():
            t.data = t.data.to(device)

    # -- API ----------------------------------------------------------------
    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._enable and self._use_dynamic

    def get_loss_scaling(self):
        return self._scale

    @torch.no_grad()
    def set_init_loss_scaling(self, v):
        # in place: a compiled step holds this tensor by address
        self._scale.fill_(float(v))

    def scale(self, var):
        """The loss times the current scale (recorded by autograd)."""
        if not self._enable:
            return var
        self._place(var.device)
        return var * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Divide the accumulated gradients by the scale, in place, and
        record whether any is non-finite (a device flag)."""
        if not self._enable:
            return
        found = None
        inv = None
        for p in optimizer._parameter_list:
            if p.grad is None:
                continue
            g = p.grad
            if inv is None:
                self._place(g.device)
                inv = torch.reciprocal(self._scale)
            g.mul_(inv.to(g.dtype))
            bad = ~torch.isfinite(g).all()
            found = bad if found is None else found | bad
        if found is None:
            found = torch.zeros((), dtype=torch.bool,
                                device=self._scale.device)
        self._found_inf = found
        self._unscaled.add(id(optimizer))

    @torch.no_grad()
    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        if id(optimizer) not in self._unscaled:
            self.unscale_(optimizer)
        found = self._found_inf
        if not _masked(found.device):
            if not bool(found):
                optimizer.step()
            self._unscaled.discard(id(optimizer))
            return
        # masked: a select, not a multiply (inf * 0 is NaN and would
        # poison the update the mask exists to suppress)
        for p in optimizer._parameter_list:
            if p.grad is not None:
                p.grad.masked_fill_(found, 0.0)
        prev = optimizer._lr_mask
        optimizer._lr_mask = found
        try:
            optimizer.step()
        finally:
            optimizer._lr_mask = prev
        self._unscaled.discard(id(optimizer))

    @torch.no_grad()
    def update(self):
        """Dynamic loss-scale bookkeeping, on the device, in place."""
        if not (self._enable and self._use_dynamic):
            return
        found = self._found_inf
        if found is None:
            return
        found_i = found.to(torch.int32)
        bad = self._bad + found_i
        growth = torch.where(found_i > 0, torch.zeros_like(bad),
                             self._growth + 1)
        shrink = bad >= self._decr_every_n_nan_or_inf
        grow = growth >= self._incr_every_n_steps
        if self._m_found_inf is not _om.NULL and not _masked(found.device):
            # one host read for both flags; none when the counters are
            # the shared no-op (PADDLE_TPU_METRICS=0)
            found_host, shrink_host = torch.stack(
                [found_i > 0, shrink]).tolist()
            if found_host:
                self._m_found_inf.inc()
            if shrink_host:
                self._m_backoff.inc()
        scale = self._scale
        scale = torch.where(shrink, scale * self._decr_ratio, scale)
        scale = torch.where(grow, scale * self._incr_ratio, scale)
        self._scale.copy_(torch.clamp_min(scale, 1.0))
        self._growth.copy_(torch.where(grow, torch.zeros_like(growth),
                                       growth))
        self._bad.copy_(torch.where(shrink, torch.zeros_like(bad), bad))
        self._found_inf = None

    def minimize(self, optimizer, scaled_loss=None):
        """unscale, then (maybe) step, then update: the reference's
        one-shot."""
        self.step(optimizer)
        self.update()

    # -- state dict ---------------------------------------------------------
    def state_dict(self):
        if not self._enable:
            return {}
        return {
            "scale": self._scale.cpu().numpy(),
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
            "incr_every_n_steps": self._incr_every_n_steps,
            "decr_every_n_nan_or_inf": self._decr_every_n_nan_or_inf,
            "growth": self._growth.cpu().numpy(),
            "bad": self._bad.cpu().numpy(),
            "use_dynamic_loss_scaling": self._use_dynamic,
        }

    @torch.no_grad()
    def load_state_dict(self, state):
        if not state:
            return
        # in place: see set_init_loss_scaling
        self._scale.fill_(float(state["scale"]))
        self._growth.fill_(int(state.get("growth", 0)))
        self._bad.fill_(int(state.get("bad", 0)))
        self._incr_ratio = float(state.get("incr_ratio", self._incr_ratio))
        self._decr_ratio = float(state.get("decr_ratio", self._decr_ratio))
        self._incr_every_n_steps = int(
            state.get("incr_every_n_steps", self._incr_every_n_steps))
        self._decr_every_n_nan_or_inf = int(
            state.get("decr_every_n_nan_or_inf",
                      self._decr_every_n_nan_or_inf))
        self._use_dynamic = bool(
            state.get("use_dynamic_loss_scaling", self._use_dynamic))


AmpScaler = GradScaler  # the reference's legacy alias
