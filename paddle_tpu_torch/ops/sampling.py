"""The sampler's random pass: threefry2x32 counter bits and Gumbel-max.

The reference draws its sampling noise from the counter-based threefry2x32
generator: a row's key is ``fold_in(key(seed), fold)``, the key
``threefry((0, seed), (0, fold))``; element ``i`` of a draw takes the bits
``y0 ^ y1`` of ``threefry(key, (i >> 32, i & 0xFFFFFFFF))``; the uniform is
``((bits >> 9) | 0x3F800000)`` read as f32, minus 1, moved into ``[tiny,
1)``; the Gumbel sample is ``-log(-log(u))``, and a categorical draw is the
argmax of the scores plus that noise. This module computes exactly that:

- :func:`gumbel_argmax` (the kernel of ``csrc/sampling.cu`` on CUDA
  tensors): per row ``argmax(where(s >= thr, s + g, -inf))`` over the
  row's ``V`` scores ``s``, with ``g`` drawn at counters ``base + j``,
  ties to the lowest index. No ``[N, V]`` noise is written to memory.
- :func:`gumbel_noise`: the same draw written out (bits, uniforms, ``g``),
  for the tests and the card check only.

The plain versions (:func:`gumbel_argmax_ref`, :func:`gumbel_noise_ref`)
derive the key and the bits in int64 tensor ops masked to 32 bits. Keys,
bits and uniforms are bit for bit the reference's; ``g`` goes through
``log`` twice, whose last bit differs between math libraries (within
``2^-13 * max(|g|, 1)``, see :data:`GUMBEL_REL`), so a token can differ
from the reference's only where the top two perturbed scores lie within
that of each other.

The kernel replaces no Pallas kernel: the reference leaves this pass to
XLA (``inference/sampling.py`` ``sampled_next_tokens``, the ``gumbel`` /
``argmax`` at its end, and ``models/llama.py`` ``_pick_token``'s
``categorical``). Its plain version is some 150 elementwise launches over
``[N, V]`` per call. On the card the kernel is bound by its integer
operations (about 85 a element for the threefry rounds, the counter and
the uniform), not by the ``N * V * 4`` bytes of scores it reads; its
design keeps every element's work in registers and reduces each row's
argmax through one 64-bit ``atomicMax`` per block on a key that orders
(value, lowest index), the row's last block writing the token.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ragged_paged_attention import _on_cpu, _readable

__all__ = ["GUMBEL_REL", "threefry2x32", "fold_key", "random_bits",
           "uniform_from_bits", "gumbel_noise_ref", "perturbed_scores",
           "gumbel_argmax_ref", "gumbel_noise", "gumbel_argmax"]

#: kernel launches on the CUDA path, one per call of each wrapper
launches = {"gumbel_argmax": 0, "gumbel_noise": 0}

#: how far ``g`` may lie from the reference's (or the kernel's from the
#: plain version's), relative to ``max(|g|, 1)``: the two ``log`` calls'
#: last bits differ between math libraries
GUMBEL_REL = 2.0 ** -13

_M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = torch.finfo(torch.float32).tiny
_ONE_BITS = 0x3F800000
#: rows a launch takes (the grid's y dimension)
MAX_ROWS = 65535


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on int64 tensors holding unsigned 32-bit
    words (broadcast together). Returns ``(y0, y1)`` in ``[0, 2^32)``."""
    ks = (k0 & _M32, k1 & _M32, (k0 ^ k1 ^ _PARITY) & _M32)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def fold_key(seeds, folds):
    """The key of ``fold_in(key(seed), fold)`` per row: ``threefry((0,
    seed), (0, fold))``, both words int64 ``[N]``."""
    seeds = seeds.long() & _M32
    zero = torch.zeros_like(seeds)
    return threefry2x32(zero, seeds, zero, folds.long() & _M32)


def random_bits(k0, k1, counters):
    """The 32 random bits of each int64 counter under the key ``(k0,
    k1)`` (broadcast): ``y0 ^ y1`` of threefry over ``(hi, lo)``."""
    y0, y1 = threefry2x32(k0, k1, counters >> 32, counters & _M32)
    return y0 ^ y1


def uniform_from_bits(bits):
    """The f32 uniform in ``[tiny, 1)`` of each 32-bit word: the top 23
    bits as a mantissa of ``[1, 2)``, minus 1, lifted to tiny (only 0
    moves)."""
    f = ((bits >> 9) | _ONE_BITS).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(f + _TINY, _TINY)


def _counters(bases, v, device):
    return bases.long()[:, None] + torch.arange(v, device=device)[None, :]


def gumbel_noise_ref(seeds, folds, bases, v):
    """The plain draw of ``[N, v]`` noise: row ``i`` under the key
    ``fold_key(seeds[i], folds[i])`` at counters ``bases[i] + j``.
    Returns ``(bits int64, u f32, g f32)``, each ``[N, v]``."""
    k0, k1 = fold_key(seeds, folds)
    bits = random_bits(k0[:, None], k1[:, None],
                       _counters(bases, v, seeds.device))
    u = uniform_from_bits(bits)
    return bits, u, -torch.log(-torch.log(u))


def perturbed_scores(scores, seeds, folds, bases, thr):
    """``where(scores >= thr, scores + g, -inf)`` in f32, ``[N, V]``: the
    values :func:`gumbel_argmax_ref` takes the argmax of (the tests read
    the top-2 margin from them)."""
    s = scores.float()
    g = gumbel_noise_ref(seeds, folds, bases, s.shape[1])[2]
    keep = s >= thr.float()[:, None]
    return torch.where(keep, s + g, torch.full_like(s, float("-inf")))


def gumbel_argmax_ref(scores, seeds, folds, bases, thr):
    """The plain version of :func:`gumbel_argmax`, int64 ``[N]``."""
    return perturbed_scores(scores, seeds, folds, bases, thr).argmax(dim=-1)


# ----------------------------------------------------------------------
# the CUDA launch
# ----------------------------------------------------------------------

def _lib():
    lib = _build.load("sampling")
    if not getattr(lib, "_sm_typed", False):
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.sm_gumbel_argmax.argtypes = [vp] * 8 + [i32, i32, vp]
        lib.sm_gumbel_argmax.restype = i32
        lib.sm_gumbel_noise.argtypes = [vp] * 6 + [i32, i32, vp]
        lib.sm_gumbel_noise.restype = i32
        lib.sm_error_string.argtypes = [i32]
        lib.sm_error_string.restype = ctypes.c_char_p
        lib._sm_typed = True
    return lib


def _check(rows, seeds, folds, bases, thr=None):
    per_row = [seeds, folds, bases] + ([thr] if thr is not None else [])
    if any(t.dim() != 1 or t.shape[0] != rows for t in per_row):
        raise ValueError(f"seeds, folds, bases and thresholds must be [N] "
                         f"with N = {rows}")
    if any(t.dtype.is_floating_point or t.dtype == torch.bool
           for t in (seeds, folds, bases)):
        raise ValueError("seeds, folds and bases must be integers")
    if len({t.device for t in per_row}) != 1:
        raise ValueError("all operands must share one device")


def _row_args(seeds, folds, bases):
    return (_readable(seeds, torch.int32, align=False),
            _readable(folds, torch.int32, align=False),
            _readable(bases, torch.int64, align=False))


def _raise(lib, rc, what):
    msg = lib.sm_error_string(rc).decode()
    raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def _check_launch(n, v):
    if n > MAX_ROWS:
        raise ValueError(f"the CUDA kernel takes at most {MAX_ROWS} rows, "
                         f"got {n}")
    if v >= 2 ** 31:
        raise ValueError(f"the CUDA kernel takes V < 2^31, got {v}")


def gumbel_noise(seeds, folds, bases, v):
    """The draw of :func:`gumbel_noise_ref` (``(bits int64, u f32, g
    f32)``, each ``[N, v]``): one launch of the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    n = seeds.shape[0]
    _check(n, seeds, folds, bases)
    if _on_cpu(seeds):
        return gumbel_noise_ref(seeds, folds, bases, v)
    _check_launch(n, v)
    sd, fd, bs = _row_args(seeds, folds, bases)
    bits = torch.empty((n, v), dtype=torch.int32, device=seeds.device)
    u = torch.empty((n, v), dtype=torch.float32, device=seeds.device)
    g = torch.empty_like(u)
    if bits.numel():
        lib = _lib()
        stream = torch.cuda.current_stream(seeds.device).cuda_stream
        rc = lib.sm_gumbel_noise(*map(_build.data_ptr,
                                      (sd, fd, bs, bits, u, g)), n, v, stream)
        if rc:
            _raise(lib, rc, "gumbel noise")
        launches["gumbel_noise"] += 1
    return bits.long() & _M32, u, g


def gumbel_argmax(scores, seeds, folds, bases, thr):
    """Per row of ``scores [N, V]`` (f32; other floats are converted): the
    index of ``max(where(scores >= thr, scores + g, -inf))``, ``g`` the
    Gumbel noise of row ``i`` under ``fold_key(seeds[i], folds[i])`` at
    counters ``bases[i] + j``; ties to the lowest index. ``thr [N]`` is the
    keep threshold (``-inf``: keep all; a NaN score is never kept). Returns
    int64 ``[N]``.

    CUDA tensors launch the kernel of ``csrc/sampling.cu`` once (and
    raise if they cannot); CPU tensors run :func:`gumbel_argmax_ref`."""
    if scores.dim() != 2:
        raise ValueError(f"scores must be [N, V], got {tuple(scores.shape)}")
    n, v = scores.shape
    _check(n, seeds, folds, bases, thr)
    if scores.device != seeds.device:
        raise ValueError("all operands must share one device")
    if _on_cpu(scores):
        return gumbel_argmax_ref(scores, seeds, folds, bases, thr)
    _check_launch(n, v)
    if n == 0 or v == 0:
        return torch.zeros((n,), dtype=torch.int64, device=scores.device)
    out = torch.empty((n,), dtype=torch.int64, device=scores.device)
    s = _readable(scores, torch.float32, align=False)
    th = _readable(thr, torch.float32, align=False)
    sd, fd, bs = _row_args(seeds, folds, bases)
    # the row keys (64-bit) and tickets, zero before and after the launch
    scratch = _build.tickets(scores.device, 3 * n)
    tickets = scratch.data_ptr() + 8 * n
    lib = _lib()
    stream = torch.cuda.current_stream(scores.device).cuda_stream
    rc = lib.sm_gumbel_argmax(
        *map(_build.data_ptr, (s, sd, fd, bs, th, out, scratch)), tickets,
        n, v, stream)
    if rc:
        _raise(lib, rc, "gumbel argmax")
    launches["gumbel_argmax"] += 1
    return out
