"""Fused linear cross-entropy: the mean next-token loss of ``hidden @
weight^T`` without the ``[N, V]`` logits (port of the reference
package's ``ops/fused_linear_cross_entropy.py``).

Shapes (N = B*S tokens, D hidden, V vocab):

  hidden  [..., D]  any float dtype; compute is f32
  weight  [V, D]    the lm head in the ``nn.Linear`` layout
  labels  [...]     int ids; ``ignore_index`` rows leave the mean
  -> loss  f32 scalar ``sum(nll[valid]) / max(count(valid), 1)``

The forward needs per row ``lse`` (log-sum-exp of the logits) and
``pick`` (the label's logit), computed online over vocab tiles: on CUDA
tensors by the hand-written kernels of
``csrc/fused_linear_cross_entropy.cu``, on CPU tensors by the plain
chunked version :func:`fused_linear_cross_entropy_ref`. There is no
fallback from one to the other. Hidden and weight may be f32, bf16 or
f16 in any mix (converted to f32 on load inside the kernel, as the
reference's body converts its blocks); labels any integer dtype. A label
outside ``[0, V)`` matches no column: its pick is 0.

One rule (:func:`kernel_instance`) picks the kernel's instance: D % 8 ==
0 goes to the tensor-core instance (3xTF32 on wgmma, the vocab split
over the grid by :func:`split_plan`), every other D >= 1 to the general
one (f32 FMAs).

The backward recomputes each vocab chunk's logits from the saved
``lse`` and accumulates ``d_hidden`` and ``d_weight`` chunk by chunk
(``(softmax - onehot) * coef``), so ``[N, V]`` never exists in either
pass. It is plain matrix products, as in the reference, where it is XLA
outside any kernel.

``PADDLE_TPU_FUSED_CE_CHUNK`` (default 8192) sets the vocab chunk of the
plain forward and of the backward.
"""

from __future__ import annotations

import ctypes
import os

import torch

from ..framework import dispatch as _dispatch
from . import _build

__all__ = ["fused_linear_cross_entropy", "fused_linear_cross_entropy_ref",
           "default_chunk", "kernel_instance", "split_plan"]

#: kernel launches on the CUDA path by instance (``kernel_instance``);
#: ``launches`` is their sum
instance_launches = _build.counter(("tensor-core", "general"))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_INSTANCES = {"tensor-core": 0, "general": 1}
TILE_ROWS = 128     # rows of a tensor-core block
TILE_COLS = 128     # vocab columns of a tensor-core tile


def __getattr__(name):
    if name == "launches":
        return sum(instance_launches.values())
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def default_chunk():
    """Vocab chunk of the plain formulation and the backward (env
    ``PADDLE_TPU_FUSED_CE_CHUNK``, default 8192)."""
    try:
        return max(8, int(os.environ.get("PADDLE_TPU_FUSED_CE_CHUNK",
                                         "8192")))
    except ValueError:
        return 8192


def fused_linear_cross_entropy_ref(h2d, w, labels, chunk):
    """The plain forward: ``(lse [N], pick [N])`` f32 by the online
    chunked log-sum-exp, one ``[N, chunk]`` f32 block at a time."""
    n = h2d.shape[0]
    v = w.shape[0]
    with torch.autocast(h2d.device.type, enabled=False):
        h32 = h2d.float()
        m = torch.full((n,), float("-inf"), device=h2d.device)
        s = torch.zeros(n, device=h2d.device)
        pick = torch.zeros(n, device=h2d.device)
        for lo in range(0, v, chunk):
            hi = min(lo + chunk, v)
            lg = torch.matmul(h32, w[lo:hi].float().t())      # [N, hi-lo]
            m_new = torch.maximum(m, lg.amax(dim=1))
            # first chunk: m == -inf, so the rescale term is 0 * 0
            s = s * torch.exp(m - m_new) \
                + torch.exp(lg - m_new[:, None]).sum(dim=1)
            m = m_new
            cols = torch.arange(lo, hi, device=h2d.device)
            pick = pick + torch.where(cols[None, :] == labels[:, None], lg,
                                      torch.zeros_like(lg)).sum(dim=1)
    return m + torch.log(s), pick


def kernel_instance(dtype_h, dtype_w, d):
    """The CUDA instance that takes hidden of ``dtype_h`` and weight of
    ``dtype_w`` (each f32, bf16 or f16) at hidden size ``d``:
    ``"tensor-core"`` for ``d % 8 == 0`` (16-byte rows), ``"general"``
    for every other ``d >= 1``. Raises for any other dtype."""
    for dt in (dtype_h, dtype_w):
        if dt not in _DTYPES:
            raise ValueError("the CUDA cross-entropy kernel takes float32, "
                             f"bfloat16 or float16 hidden and weight, got "
                             f"{dt}")
    return "tensor-core" if d > 0 and d % 8 == 0 else "general"


def split_plan(v, sms):
    """``(splits, per)``: the tensor-core instance's vocab split. Split
    ``y`` walks the vocab tiles of 128 columns ``[y per, (y + 1) per)``:
    ``per`` tiles each, as few as leave at most ``sms`` splits, and no
    split empty. A function of V and the SM count only, never of the
    rows: a row's lse and pick are the same bits whatever N."""
    tiles = -(-v // TILE_COLS)
    per = -(-tiles // max(1, sms))
    return -(-tiles // per), per


def _lib():
    lib = _build.load("fused_linear_cross_entropy")
    if not getattr(lib, "_ce_typed", False):
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ce_forward.argtypes = [i32] + [vp] * 5 + [i32] * 7 + [vp] * 3
        lib.ce_forward.restype = i32
        lib.ce_error_string.argtypes = [i32]
        lib.ce_error_string.restype = ctypes.c_char_p
        lib._ce_typed = True
    return lib


def _launch(h2d, w, labels):
    """The instance :func:`kernel_instance` picks. Raises only for what
    no instance takes: other dtypes than f32, bf16 and f16, and
    misaligned hidden or weight on the tensor-core instance."""
    n, d = h2d.shape
    v = w.shape[0]
    inst = kernel_instance(h2d.dtype, w.dtype, d)
    h2d, w = h2d.contiguous(), w.contiguous()
    if inst == "tensor-core" and (h2d.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError("the CUDA cross-entropy kernel's tensor-core "
                         "instance takes 16-byte aligned hidden and weight")
    lab = labels.to(torch.int64).contiguous()
    lse = torch.empty(n, dtype=torch.float32, device=h2d.device)
    pick = torch.empty(n, dtype=torch.float32, device=h2d.device)
    if n == 0:
        return lse, pick
    splits, per = split_plan(v, _build.sm_count(h2d.device))
    partial = tickets = None
    if inst == "tensor-core":
        partial = torch.empty((splits, 3, n), dtype=torch.float32,
                              device=h2d.device)
        tickets = _build.tickets(h2d.device, -(-n // TILE_ROWS))
    lib = _lib()
    rc = lib.ce_forward(_INSTANCES[inst], h2d.data_ptr(), w.data_ptr(),
                        lab.data_ptr(), lse.data_ptr(), pick.data_ptr(), n,
                        d, v, _DTYPES[h2d.dtype], _DTYPES[w.dtype], splits,
                        per, _build.data_ptr(partial),
                        _build.data_ptr(tickets),
                        torch.cuda.current_stream(h2d.device).cuda_stream)
    if rc:
        msg = lib.ce_error_string(rc).decode()
        raise RuntimeError(f"cross-entropy launch failed: CUDA error {rc} "
                           f"({msg})")
    instance_launches[inst] += 1
    return lse, pick


def _parts(h2d, w, labels, chunk):
    if h2d.device.type == "cuda":
        return _launch(h2d, w, labels)
    if h2d.device.type != "cpu":
        raise ValueError(f"unsupported device {h2d.device}")
    return fused_linear_cross_entropy_ref(h2d, w, labels, chunk)


def linear_cross_entropy_backward(h2d, w, labels, lse, g, chunk,
                                  ignore_index):
    """``(d_hidden, d_weight)`` of the per-row nll from the saved
    ``lse``, one vocab chunk at a time: each chunk's logits are
    recomputed and ``(softmax - onehot) * g`` feeds both products."""
    n, d = h2d.shape
    v = w.shape[0]
    with torch.autocast(h2d.device.type, enabled=False):
        h32 = h2d.float()
        coef = torch.where(labels != ignore_index, g.float(),
                           torch.zeros_like(lse))                # [N]
        dh = torch.zeros((n, d), dtype=torch.float32, device=h2d.device)
        # every vocab row of d_weight is written once, in place
        dw = torch.empty_like(w)
        for lo in range(0, v, chunk):
            hi = min(lo + chunk, v)
            wc = w[lo:hi].float()
            lg = torch.matmul(h32, wc.t())
            p = torch.exp(lg - lse[:, None])
            cols = torch.arange(lo, hi, device=h2d.device)
            hot = (cols[None, :] == labels[:, None]).float()
            dlg = (p - hot) * coef[:, None]                      # [N, hi-lo]
            dh += torch.matmul(dlg, wc)
            dw[lo:hi] = torch.matmul(dlg.t(), h32).to(w.dtype)
    return dh.to(h2d.dtype), dw


class _FusedLinearCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h2d, w, labels, chunk, ignore_index):
        lse, pick = _parts(h2d, w, labels, chunk)
        valid = labels != ignore_index
        nll = torch.where(valid, lse - pick, torch.zeros_like(lse))
        ctx.save_for_backward(h2d, w, labels, lse)
        ctx.chunk, ctx.ignore_index = chunk, ignore_index
        return nll

    @staticmethod
    def backward(ctx, g):
        h2d, w, labels, lse = ctx.saved_tensors
        dh, dw = linear_cross_entropy_backward(h2d, w, labels, lse, g,
                                               ctx.chunk, ctx.ignore_index)
        return dh, dw, None, None, None


@_dispatch.op("fused_linear_cross_entropy")
def fused_linear_cross_entropy(hidden, weight, labels, ignore_index=-100,
                               vocab_chunk=None):
    """Mean next-token cross entropy of ``hidden @ weight^T`` against
    ``labels`` without the logits (module docstring). ``hidden [..., D]``
    and ``labels [...]`` flatten together; ``weight`` is ``[V, D]``.
    Returns an f32 scalar; differentiable in ``hidden`` and ``weight``."""
    if weight.dim() != 2 or hidden.shape[-1] != weight.shape[1]:
        raise ValueError(f"expected hidden [..., D] and weight [V, D]; got "
                         f"{tuple(hidden.shape)} and {tuple(weight.shape)}")
    if hidden.device != weight.device or hidden.device != labels.device:
        raise ValueError("hidden, weight and labels must share one device")
    chunk = int(vocab_chunk) if vocab_chunk else default_chunk()
    h2d = hidden.reshape(-1, hidden.shape[-1])
    lab = labels.reshape(-1)
    c = max(8, min(chunk, weight.shape[0]))
    nll = _FusedLinearCrossEntropy.apply(h2d, weight, lab, c,
                                         int(ignore_index))
    valid = (lab != ignore_index).float()
    return nll.sum() / valid.sum().clamp_min(1.0)
