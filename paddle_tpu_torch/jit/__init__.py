"""``jit.to_static`` as a CUDA-graph step (port of the reference
package's ``jit/__init__.py``: ``to_static``, ``StaticFunction``,
``enable_to_static``, ``not_to_static``, ``ignore_module``).

The reference traces an imperative train step (forward,
``loss.backward()``, ``opt.step()``) into one compiled program. Here the
compiled form of a step is one CUDA graph per input signature (the
inputs' shapes, dtypes and devices, the non-tensor arguments, the
modules' training flags, which parameters hold gradients, the active
``auto_cast`` policy), captured by :class:`~paddle_tpu_torch.ops._graphs
.StepGraphs` under its ``CAPTURE_LOCK``:

1. **warm-up** (the reference's): the first call of a signature runs the
   function eagerly on the caller's arguments, which makes the optimizer
   state; with ``warmup="once"`` only the first call of all does, so the
   recipe warms up on a tiny shape and its full shape goes straight to
   step 2.
2. **capture**: the arguments are copied into static buffers and
   ``StepGraphs.capture`` runs the function once on them (a real step,
   whose outputs this call returns: every kernel's first-call work, a
   build, a ``cudaFuncSetAttribute``, cuBLAS's workspace, happens there),
   frees the allocator's cached blocks, and captures the function. So
   every call performs exactly one step, and a compiled loop's losses are
   an eager loop's.
3. **replay**: the arguments are copied into the buffers with ``copy_``,
   each optimizer's device learning rate is refilled from its schedule,
   the graph is replayed, and clones of the static outputs are returned.

Every output is detached, the warm-up's too, as the reference's compiled
outputs stop gradients: a loss that kept its autograd graph alive would
keep the parameters' gradient-accumulation nodes of the stream that made
them, and the capture, on its own stream, could not use them.

At capture no parameter may hold a gradient: backward then allocates the
gradients in the graph's memory pool and ``clear_grad()`` inside the
step only drops the references. Optimizer state is made in the warm-up
(made under a capture it raises). Each capture reports one compile of
the callable to :mod:`~paddle_tpu_torch.observability.compile_watch`. A
failed capture raises: no call falls back to the eager step. On the CPU
there is nothing to capture: every call after the warm-up runs the
function eagerly on the same static buffers.

The state a step changes (modules, optimizers, tensors, and the tensors
an object lists in ``__state_tensors__()``, a ``GradScaler``'s) is found
as the reference finds it: ``state=[...]``, the function's closure, its
``__self__`` and the globals it names. Every call after the warm-up runs
its Python as a compiled step (:func:`in_compiled_step`), where a
``GradScaler`` masks an overflow step as the reference's traced step
does. Parameters and optimizer state
are updated in place, so ``donate`` and ``donate_inputs`` are accepted
for the reference's signature and change nothing. ``jit.save`` and
``jit.load`` are not ported yet (ROADMAP A14).
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import threading
import types

import torch
from torch.utils import _pytree as pytree

from .. import amp as _amp
from ..ops._graphs import StepGraphs
from ..optimizer import Optimizer

__all__ = ["to_static", "not_to_static", "ignore_module", "StaticFunction",
           "enable_to_static", "in_compiled_step", "save", "load"]

_to_static_enabled = True
_local = threading.local()
_running_lock = threading.Lock()
_running = 0        # compiled steps running, on any thread


def in_compiled_step():
    """True while this thread runs a compiled call: the capture call's
    real step and its capture, each replay with its buffer fills and
    output copies, and on the CPU every call after the warm-up (the
    reference's traced calls). ``amp.GradScaler`` masks an
    overflow step there instead of reading its flag on the host."""
    return getattr(_local, "depth", 0) > 0


def compiled_steps_running():
    """How many compiled steps run now, on any thread (the tensor
    checker's skip: a step's backward on the card runs on the autograd
    engine's threads, where :func:`in_compiled_step` is False)."""
    return _running


@contextlib.contextmanager
def _compiled():
    global _running
    _local.depth = getattr(_local, "depth", 0) + 1
    with _running_lock:
        _running += 1
    try:
        yield
    finally:
        _local.depth -= 1
        with _running_lock:
            _running -= 1


def enable_to_static(flag: bool):
    """``False`` makes every compiled function run its Python eagerly."""
    global _to_static_enabled
    _to_static_enabled = bool(flag)


def _discover_state(fn, extra):
    """The modules, optimizers and tensors ``fn`` changes: those in
    ``extra``, in its closure cells, its ``__self__``, and the globals
    its code names (holder objects scanned one attribute level deep)."""
    seen = set()
    layers, optimizers, tensors = [], [], []

    def visit(obj, depth=0):
        if id(obj) in seen:
            return
        seen.add(id(obj))
        if isinstance(obj, torch.nn.Module):
            layers.append(obj)
        elif isinstance(obj, Optimizer):
            optimizers.append(obj)
        elif isinstance(obj, torch.Tensor):
            tensors.append(obj)
        elif hasattr(obj, "__state_tensors__"):
            for t in obj.__state_tensors__():
                visit(t, depth)
        elif isinstance(obj, (list, tuple)):
            for e in obj:
                visit(e, depth)
        elif isinstance(obj, dict):
            for e in obj.values():
                visit(e, depth)
        elif depth < 2 and not isinstance(
                obj, (types.ModuleType, types.FunctionType,
                      types.MethodType, type, str, bytes, int, float,
                      bool, complex)) and hasattr(obj, "__dict__"):
            # a plain holder (a Trainer with .model and .opt)
            for e in vars(obj).values():
                visit(e, depth + 1)

    for obj in extra or ():
        visit(obj)
    for cell in getattr(fn, "__closure__", None) or ():
        try:
            visit(cell.cell_contents)
        except ValueError:
            pass
    self_obj = getattr(fn, "__self__", None)
    if self_obj is not None:
        visit(self_obj)
    code = getattr(fn, "__code__", None)
    if code is not None:
        g = getattr(fn, "__globals__", {})
        for name in code.co_names:
            obj = g.get(name)
            if obj is None or isinstance(
                    obj, (types.ModuleType, types.FunctionType,
                          types.BuiltinFunctionType, type, str, bytes,
                          int, float, bool)):
                continue
            if isinstance(obj, (torch.nn.Module, Optimizer, torch.Tensor,
                                list, tuple, dict)):
                visit(obj)
                continue
            mod = type(obj).__module__ or ""
            if mod.split(".")[0] in ("numpy", "torch", "builtins"):
                continue
            # co_names mixes globals with attribute names: holders are
            # scanned for their direct state attributes only
            visit(obj, depth=1)
    return layers, optimizers, tensors


def _detached(out):
    """``out`` with every tensor detached. A step's outputs never carry
    its autograd graph: a graph kept alive by a returned loss keeps the
    parameters' gradient-accumulation nodes of the stream that made them,
    and a later capture on another stream cannot use them."""
    return pytree.tree_map(
        lambda o: o.detach() if isinstance(o, torch.Tensor) else o, out)


def _amp_key():
    st = _amp._stack()
    if not st:
        return None
    pol = st[-1]
    return (str(pol.dtype), pol.white, pol.black)


class StaticFunction:
    """The compiled wrapper :func:`to_static` returns."""

    def __init__(self, function, input_spec=None, state=None, donate=True,
                 warmup="per-signature", donate_inputs=False, name=None):
        if warmup not in ("per-signature", "once"):
            raise ValueError(
                f"warmup must be 'per-signature' or 'once', got {warmup!r}")
        functools.update_wrapper(self, function)
        self._fn = function
        self._extra_state = state
        self._warmup = warmup
        self._warmed_any = False
        self._warm = set()          # signatures already run eagerly once
        self._cache = {}            # signature -> (index, static outputs)
        self._graphs = None         # StepGraphs, made at the first capture
        self._layers = []
        self._optimizers = []
        self._params = None
        if name:
            self._watch_name = name
        else:
            qn = getattr(function, "__qualname__", None)
            mod = getattr(function, "__module__", None)
            self._watch_name = (f"{mod}.{qn}" if mod else qn) if qn \
                else type(function).__name__

    # -- state --------------------------------------------------------------
    def _collect_state(self):
        layers, optimizers, tensors = _discover_state(
            self._fn, self._extra_state)
        self._layers, self._optimizers = layers, optimizers
        params, seen = [], set()
        for t in [p for m in layers for p in m.parameters()] + \
                [p for o in optimizers for p in o._parameter_list] + tensors:
            if id(t) not in seen:
                seen.add(id(t))
                params.append(t)
        self._params = params

    def _release_graphs(self):
        """Detach the tensors the state's modules hold as plain attributes
        (``LlamaMoEMLP.l_aux``, ``MoELayer.l_aux``): a graph kept alive
        there keeps the parameters' gradient-accumulation nodes of the
        stream that made them, as a returned loss would (:func:`_detached`),
        and a capture on another stream cannot use them."""
        for layer in self._layers:
            for mod in layer.modules():
                for k, v in list(vars(mod).items()):
                    if isinstance(v, torch.Tensor) and v.grad_fn is not None:
                        setattr(mod, k, v.detach())

    def _signature(self, leaves, spec):
        shapes = tuple(
            (tuple(a.shape), str(a.dtype), str(a.device))
            if isinstance(a, torch.Tensor)
            else (type(a).__name__, a if isinstance(
                a, (int, float, bool, str, type(None))) else None)
            for a in leaves)
        training = tuple(m.training for m in self._layers)
        grads = tuple(t.grad is not None for t in self._params)
        return (shapes, repr(spec), training, grads, _amp_key())

    def _device(self, leaves):
        for t in self._params:
            return t.device
        for a in leaves:
            if isinstance(a, torch.Tensor):
                return a.device
        return torch.device("cpu")

    # -- calls --------------------------------------------------------------
    def __call__(self, *args, **kwargs):
        if not _to_static_enabled:
            return self._fn(*args, **kwargs)
        leaves, spec = pytree.tree_flatten((args, kwargs))
        if self._params is None:
            self._collect_state()
        sig = self._signature(leaves, spec)
        if sig not in self._warm and not (self._warmup == "once"
                                          and self._warmed_any):
            # the reference's eager warm-up: marked warm only once it ran
            out = _detached(self._fn(*args, **kwargs))
            self._warm.add(sig)
            self._warmed_any = True
            self._collect_state()
            self._release_graphs()
            self._warm.add(self._signature(leaves, spec))
            return out
        if self._graphs is None:
            self._graphs = StepGraphs(self._device(leaves),
                                      name=self._watch_name)
        # the whole call is the compiled step, its buffer fills and output
        # copies included: the tensor checker reads none of them
        with _compiled():
            entry = self._cache.get(sig)
            if entry is None:
                return self._capture(sig, leaves, spec)
            index, out_leaves, out_spec = entry
            self._fill(index, leaves)
            if not self._graphs.cuda:
                return _detached(self._run(index, leaves, spec))
            for o in self._optimizers:
                o.refresh_lr()
            self._graphs.replay(sig)
            return pytree.tree_unflatten(
                [o.clone() if isinstance(o, torch.Tensor) else o
                 for o in out_leaves], out_spec)

    def _buffers(self, index, leaves):
        return [self._graphs.buffer(f"{index}.{i}", a.shape, a.dtype)
                if isinstance(a, torch.Tensor) else a
                for i, a in enumerate(leaves)]

    def _fill(self, index, leaves):
        with torch.no_grad():
            for buf, a in zip(self._buffers(index, leaves), leaves):
                if isinstance(a, torch.Tensor):
                    buf.copy_(a)

    def _run(self, index, leaves, spec):
        """The function on the static buffers of signature ``index``, as a
        compiled step (:func:`in_compiled_step`)."""
        args, kwargs = pytree.tree_unflatten(self._buffers(index, leaves),
                                             spec)
        with _compiled():
            return self._fn(*args, **kwargs)

    def _capture(self, sig, leaves, spec):
        index = len(self._cache)
        self._fill(index, leaves)
        if not self._graphs.cuda:
            out = _detached(self._run(index, leaves, spec))
            self._cache[sig] = (index, None, None)
            return out
        outs = []

        def step():
            outs.append(self._run(index, leaves, spec))

        def before_capture():
            held = [n for n, t in zip(self._param_names(), self._params)
                    if t.grad is not None]
            if held:
                raise RuntimeError(
                    f"to_static({self._watch_name}): {len(held)} parameters "
                    f"hold gradients at capture ({held[:3]}...): the step "
                    "must end with opt.clear_grad() so that backward "
                    "allocates them in the graph's pool")
            self._release_graphs()
            torch.clear_autocast_cache()
            torch.cuda.empty_cache()

        self._graphs.capture(sig, step, signature=self._sig_desc(sig),
                             before_capture=before_capture)
        self._release_graphs()
        torch.clear_autocast_cache()
        warm, static = outs
        out_leaves, out_spec = pytree.tree_flatten(_detached(static))
        self._cache[sig] = (index, out_leaves, out_spec)
        return _detached(warm)

    def _param_names(self):
        names = {id(p): n for m in self._layers
                 for n, p in m.named_parameters()}
        return [names.get(id(t), f"tensor_{i}")
                for i, t in enumerate(self._params)]

    def _sig_desc(self, sig):
        """The compile watcher's signature: the input shapes (what a
        recompile storm names) and the rest of the key."""
        shapes, tree, training, grads, amp_key = sig
        desc = []
        for i, s in enumerate(shapes):
            if isinstance(s[0], tuple):
                dtype = s[1].replace("torch.", "")
                desc.append((f"arg{i}",
                             f"{dtype}[{','.join(str(d) for d in s[0])}]"))
            else:
                desc.append((f"arg{i}", f"{s[0]}={s[1]!r}"))
        desc.append(("training", str(training)))
        desc.append(("grads", str(sum(grads))))
        desc.append(("amp", str(None if amp_key is None else amp_key[0])))
        return "; ".join(f"{k}={v}" for k, v in desc)

    @property
    def code(self):
        return inspect.getsource(self._fn)

    def rollback(self):
        return self._fn


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, state=None, full_graph=True,
              warmup="per-signature", name=None, donate_inputs=False,
              **kwargs):
    """Compile an imperative step into one CUDA graph per input signature
    (see the module docstring). The reference's call shapes: a bare
    decorator, a decorator with arguments, or a direct wrap of a module
    (its ``forward`` is replaced).

    ``state`` lists the modules, optimizers and tensors the function
    changes (found from the closure when omitted). ``warmup="once"``: only
    the first call runs eagerly; later shapes capture straight away."""
    def wrap(fn):
        if isinstance(fn, torch.nn.Module):
            layer = fn
            layer.forward = StaticFunction(
                layer.forward, input_spec=input_spec,
                state=[layer] + list(state or ()), warmup=warmup,
                donate_inputs=donate_inputs,
                name=name or type(layer).__name__)
            return layer
        return StaticFunction(fn, input_spec=input_spec, state=state,
                              warmup=warmup, donate_inputs=donate_inputs,
                              name=name)
    if function is not None:
        return wrap(function)
    return wrap


def not_to_static(fn):
    fn._not_to_static = True
    return fn


def ignore_module(modules):
    pass


def save(layer, path, input_spec=None, **configs):
    raise NotImplementedError(
        "jit.save is not ported yet (ROADMAP A14: the inference "
        "Predictor, through torch.export)")


def load(path, **configs):
    raise NotImplementedError(
        "jit.load is not ported yet (ROADMAP A14: the inference "
        "Predictor, through torch.export)")
