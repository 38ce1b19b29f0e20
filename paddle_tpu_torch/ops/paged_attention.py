"""Paged attention: decode-step GQA attention over a paged KV pool (port
of ``paddle_tpu/ops/paged_attention.py``).

Shapes:

  q             [B, H, D]              one new token per sequence
  k/v_pages     [P, Hk, page, D]       the pool, head-major, any float
  block_tables  [B, W] int             page ids per sequence, in position
                                       order; entries past a row's live
                                       pages may hold anything
  context_lens  [B] int                valid tokens per sequence,
                                       *including* the current one (its
                                       K/V already written); 0 marks an
                                       inactive row
  -> out        [B, H, D]              in q's dtype

Query head ``h`` reads kv head ``h // (H // Hk)``. Row b attends its
first ``min(context_lens[b], W * page)`` keys: a context longer than
the table attends the table's ``W * page`` keys, as the reference's two
paths do. Scores are f32, with q times the scale (default
``1/sqrt(D)``) rounded in f32 before the product; masked keys get the
finite ``-1e30``.

One stated difference from the reference: a row with ``context_len ==
0`` comes back as zeros. The reference's Pallas kernel gives NaN there
(0 / 0) and its ``paged_attention_xla`` the mean of the row's gathered
V (a softmax over equal ``-1e30`` logits).

On a CUDA tensor :func:`paged_attention` launches the hand-written
kernel of ``csrc/paged_attention.cu``; on a CPU tensor it runs the plain
version :func:`paged_attention_ref`. There is no fallback from one to
the other. Decode is inference only: no gradient is defined.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ragged_paged_attention import NEG_INF, _on_cpu, _scale

__all__ = ["supported", "paged_attention_ref", "paged_attention"]

#: kernel launches on the CUDA path, one per call
launches = {"paged": 0}

#: the C entry's code for each pool dtype
_KV_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}

_PRECONDITIONS = (
    "paged_attention preconditions not met: need q [B,H,D], pages "
    "[P,Hk,page,D] (page % 8 == 0, D % 8 == 0, D <= 256, "
    "H % Hk == 0), tables [B,max_pages], lens [B]")


def _shape_ok(q, k_pages, v_pages, block_tables, context_lens):
    """The reference's rule (its ``supported``) on the operands' shapes."""
    qs, ks = tuple(q.shape), tuple(k_pages.shape)
    bt, cl = tuple(block_tables.shape), tuple(context_lens.shape)
    if len(qs) != 3 or len(ks) != 4 or len(bt) != 2 or len(cl) != 1:
        return False
    b, h, d = qs
    _, hk, page_size, dk = ks
    if tuple(v_pages.shape) != ks:
        return False
    if d != dk or hk == 0 or h % hk or bt[0] != b or cl[0] != b:
        return False
    return not (d % 8 or d > 256 or page_size % 8)


def _check(q, k_pages, v_pages, block_tables, context_lens):
    ops = (q, k_pages, v_pages, block_tables, context_lens)
    if not _shape_ok(*ops):
        raise ValueError(_PRECONDITIONS)
    devs = {a.device for a in ops}
    if len(devs) != 1:
        raise ValueError(f"all operands must share one device, got {devs}")
    if not _on_cpu(q):
        _check_kernel(*ops)


def _check_kernel(q, k_pages, v_pages, block_tables, context_lens):
    """The kernel's own limits on CUDA operands, past the reference's
    rule: bf16, f16 or f32 pools of one dtype, q in that dtype or f32,
    int32 tables and lens, contiguous operands, 16-byte aligned pools,
    and the group's q and accumulators within one block's shared
    memory."""
    kv = k_pages.dtype
    if kv not in _KV_DTYPES or v_pages.dtype != kv \
            or q.dtype not in (kv, torch.float32):
        raise ValueError(
            "the CUDA kernel takes bfloat16, float16 or float32 pools of "
            "one dtype and q in the pools' dtype or float32; got q "
            f"{q.dtype}, pools {k_pages.dtype}/{v_pages.dtype}")
    if block_tables.dtype != torch.int32 \
            or context_lens.dtype != torch.int32:
        raise ValueError("block tables and context lens must be int32")
    ops = (q, k_pages, v_pages, block_tables, context_lens)
    if not all(a.is_contiguous() for a in ops):
        raise ValueError("the CUDA kernel takes contiguous operands")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("the CUDA kernel streams 16-byte vectors from "
                         "16-byte aligned pools")
    h, d = q.shape[1:]
    hk = k_pages.shape[1]
    if h and not _lib().pa_smem_bytes(h // hk, d, kv.itemsize):
        raise ValueError(
            f"the CUDA kernel cannot hold a group of {h // hk} query heads "
            f"at head_dim {d} in one block's shared memory")


def supported(q, k_pages, v_pages, block_tables, context_lens):
    """Whether :func:`paged_attention` takes these operands: the
    reference's rule on shapes (``page % 8 == 0``, ``D % 8 == 0``, ``D <=
    256``, ``H % Hk == 0``) and, on CUDA tensors, the kernel's own limits
    (:func:`_check_kernel`)."""
    try:
        _check(q, k_pages, v_pages, block_tables, context_lens)
    except ValueError:
        return False
    return True


def paged_attention_ref(q, k_pages, v_pages, block_tables, context_lens,
                        scale=None):
    """The plain version: gather every row's pages into one window ``[B,
    W * page, Hk, D]``, repeat the kv heads to H, f32 scores of the
    scaled q, ``-1e30`` past the context, softmax, f32 product, cast to
    q's dtype. Rows with ``context_len == 0`` give zeros. Table entries
    are clamped into ``[0, P)`` for the gather; the mask hides what the
    clamped tail reads."""
    b, h, d = q.shape
    p, hk, _, _ = k_pages.shape
    group = h // hk
    s = _scale(scale, d)
    tables = block_tables.long().clamp(0, p - 1)
    # [B, W, Hk, page, D] -> [B, W * page, Hk, D]
    k = k_pages[tables].transpose(2, 3).reshape(b, -1, hk, d)
    v = v_pages[tables].transpose(2, 3).reshape(b, -1, hk, d)
    kq = k.repeat_interleave(group, dim=2).float()
    vq = v.repeat_interleave(group, dim=2).float()
    logits = torch.einsum("bhd,bshd->bhs", q.float() * s, kq)
    kpos = torch.arange(k.shape[1], device=q.device)[None, None, :]
    valid = kpos < context_lens.long()[:, None, None]
    logits = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1)
    # inactive rows -> zeros, not softmax's uniform weights
    w = torch.where(valid.any(dim=-1, keepdim=True), w, torch.zeros_like(w))
    return torch.einsum("bhs,bshd->bhd", w, vq).to(q.dtype)


# ----------------------------------------------------------------------
# the CUDA launch
# ----------------------------------------------------------------------

def _lib():
    lib = _build.load("paged_attention")
    if not getattr(lib, "_pa_typed", False):
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.pa_attention.argtypes = [i32] * 2 + [vp] * 6 + [i32] * 7 \
            + [ctypes.c_float, vp]
        lib.pa_attention.restype = i32
        lib.pa_smem_bytes.argtypes = [i32] * 3
        lib.pa_smem_bytes.restype = i32
        lib.pa_error_string.argtypes = [i32]
        lib.pa_error_string.restype = ctypes.c_char_p
        lib._pa_typed = True
    return lib


def _launch(q, k_pages, v_pages, block_tables, context_lens, scale):
    b, h, d = q.shape
    p, hk, page_size, _ = k_pages.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.pa_attention(
        _KV_DTYPES[k_pages.dtype], int(q.dtype == torch.float32),
        *map(_build.data_ptr, (q, k_pages, v_pages, block_tables,
                               context_lens, out)),
        b, h, hk, d, p, page_size, block_tables.shape[1], float(scale),
        stream)
    if rc:
        msg = lib.pa_error_string(rc).decode()
        raise RuntimeError(f"paged attention launch failed: CUDA error {rc} "
                           f"({msg})")
    launches["paged"] += 1
    return out


def paged_attention(q, k_pages, v_pages, block_tables, context_lens,
                    scale=None):
    """Decode-step attention over the paged pool (see the module
    docstring for shapes). Returns ``out [B, H, D]`` in q's dtype.

    CUDA tensors launch the hand-written kernel (bf16, f16 or f32 pools;
    q in the pools' dtype or f32; int32 tables and lens) and raise if
    they cannot; CPU tensors run :func:`paged_attention_ref`. Operands
    outside the reference's rule raise :class:`ValueError` with its
    message on either device."""
    _check(q, k_pages, v_pages, block_tables, context_lens)
    s = _scale(scale, q.shape[-1])
    if _on_cpu(q):
        return paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   context_lens, s)
    return _launch(q, k_pages, v_pages, block_tables, context_lens, s)
