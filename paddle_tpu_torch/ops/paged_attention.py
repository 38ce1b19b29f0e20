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

The CUDA launch takes every operand the reference takes, converting
what the reference converts before the launch: tables and lens of any
integer dtype become int32, read-only operands that are not contiguous
(or not 16-byte aligned) are copied. Two instances, picked by the pools'
dtype (:func:`kernel_instance`):

- ``"tensor-core"``: bf16 and f16 pools. q of the pools' dtype goes in
  as it is, an f32 q as f32 (the kernel splits it into 16-bit parts),
  any other 16-bit q as f32 (exact); out comes back in q's dtype.
  mma.sync on the tensor cores, f32-grade against the plain version.
- ``"general"``: f32 pools and raw int8 pools (read as they are, no
  scales, as the reference reads them). q goes in as f32 (exact) and out
  is cast back to q's dtype. f32 FMAs on the CUDA cores.

Both split each row's keys over blocks by one rule, :func:`split_plan`,
and merge the splits in split order within the one launch.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ragged_paged_attention import NEG_INF, _on_cpu, _readable, _scale

__all__ = ["supported", "kernel_instance", "split_plan",
           "paged_attention_ref", "paged_attention"]

#: kernel launches on the CUDA path, one per call
launches = {"paged": 0}
#: the launches by instance (:func:`kernel_instance`)
instance_launches = {"tensor-core": 0, "general": 0}

#: the C entry's code for each pool dtype, by instance
_KV_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2,
              torch.int8: 3}
_INSTANCES = {"tensor-core": 0, "general": 1}
#: query heads of a tile (csrc: tc::kRows, gen::kRows)
TILE_ROWS = {"tensor-core": 16, "general": 8}
# the split plan (csrc: kSplitUnit, kLongKeys): splits of SPLIT_UNIT keys,
# half that where a row attends at most LONG_KEYS / 2, twice that where it
# attends more than LONG_KEYS
SPLIT_UNIT = 256
LONG_KEYS = 1024

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
    rule: float q; K and V pools of one dtype, bf16, f16, f32 or int8;
    integer tables and lens (the launch converts the rest)."""
    if not q.dtype.is_floating_point or q.dtype == torch.float64:
        raise ValueError(f"the CUDA kernel takes a bfloat16, float16 or "
                         f"float32 q; got {q.dtype}")
    kv = k_pages.dtype
    if kv not in _KV_DTYPES or v_pages.dtype != kv:
        raise ValueError(
            "the CUDA kernel takes K and V pools of one dtype, bfloat16, "
            f"float16, float32 or int8; got {k_pages.dtype}/{v_pages.dtype}")
    if block_tables.dtype.is_floating_point \
            or context_lens.dtype.is_floating_point \
            or torch.bool in (block_tables.dtype, context_lens.dtype):
        raise ValueError("block tables and context lens must be integers")


def kernel_instance(kv_dtype):
    """The CUDA instance that takes pools of ``kv_dtype``:
    ``"tensor-core"`` for bf16 and f16, ``"general"`` for f32 and int8."""
    if kv_dtype in (torch.bfloat16, torch.float16):
        return "tensor-core"
    if kv_dtype in (torch.float32, torch.int8):
        return "general"
    raise ValueError(f"no CUDA instance takes {kv_dtype} pools")


def split_plan(context_len, width, page_size):
    """The kernel's split of one row's keys, the rule both instances
    apply: ``[(k_lo, k_hi), ...]`` over the keys ``[0, n)`` the row
    attends, ``n = min(context_len, width * page_size)`` (none for
    ``context_len <= 0``), in runs of ``SPLIT_UNIT`` keys, half that
    where ``n <= LONG_KEYS / 2``, twice that where ``n > LONG_KEYS``. It reads the row's own context and the
    table's capacity only, never another row or the card."""
    n = max(0, min(int(context_len), width * page_size))
    split = 2 * SPLIT_UNIT if n > LONG_KEYS else (
        SPLIT_UNIT if n > LONG_KEYS // 2 else SPLIT_UNIT // 2)
    return [(lo, min(lo + split, n)) for lo in range(0, n, split)]


def grid_splits(width, page_size):
    """Splits of the launch's grid: the most :func:`split_plan` gives
    any row of a ``width``-page table (csrc: ``grid_splits``)."""
    cap = width * page_size
    return max(1, -(-min(cap, LONG_KEYS // 2) // (SPLIT_UNIT // 2)),
               -(-min(cap, LONG_KEYS) // SPLIT_UNIT),
               -(-cap // (2 * SPLIT_UNIT)))


def supported(q, k_pages, v_pages, block_tables, context_lens):
    """Whether :func:`paged_attention` takes these operands: the
    reference's rule on shapes (``page % 8 == 0``, ``D % 8 == 0``, ``D <=
    256``, ``H % Hk == 0``) and, on CUDA tensors, the kernel's dtypes
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
        lib.pa_attention.argtypes = [i32] * 3 + [vp] * 9 + [i32] * 8 \
            + [ctypes.c_float, vp]
        lib.pa_attention.restype = i32
        lib.pa_error_string.argtypes = [i32]
        lib.pa_error_string.restype = ctypes.c_char_p
        lib._pa_typed = True
    return lib


def _launch(q, k_pages, v_pages, block_tables, context_lens, scale):
    b, h, d = q.shape
    p, hk, page_size, _ = k_pages.shape
    w = block_tables.shape[1]
    inst = kernel_instance(k_pages.dtype)
    # q as the instance takes it: the pools' dtype or f32 (exact)
    qdt = q.dtype if inst == "tensor-core" and q.dtype in (
        k_pages.dtype, torch.float32) else torch.float32
    qk = _readable(q, qdt)
    out = torch.empty_like(qk)
    if out.numel() == 0 or w == 0:
        return out.zero_().to(q.dtype)
    tables = _readable(block_tables, torch.int32, align=False)
    lens = _readable(context_lens, torch.int32, align=False)
    kp, vp = _readable(k_pages), _readable(v_pages)
    rows = TILE_ROWS[inst]
    tiles = -(-(h // hk) // rows)
    slab = grid_splits(w, page_size) * min(rows, h // hk)
    n = b * hk * tiles * slab
    part_o = torch.empty((n * d,), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((n * 2,), dtype=torch.float32, device=q.device)
    tickets = _build.tickets(q.device, b * hk * tiles)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.pa_attention(
        _INSTANCES[inst], _KV_DTYPES[k_pages.dtype],
        int(qdt == torch.float32),
        *map(_build.data_ptr, (qk, kp, vp, tables, lens, out, part_o,
                               part_ml, tickets)),
        b, h, hk, d, p, page_size, w, slab, float(scale), stream)
    if rc:
        msg = lib.pa_error_string(rc).decode()
        raise RuntimeError(f"paged attention launch failed: CUDA error {rc} "
                           f"({msg})")
    launches["paged"] += 1
    instance_launches[inst] += 1
    return out if out.dtype == q.dtype else out.to(q.dtype)


def paged_attention(q, k_pages, v_pages, block_tables, context_lens,
                    scale=None):
    """Decode-step attention over the paged pool (see the module
    docstring for shapes). Returns ``out [B, H, D]`` in q's dtype.

    CUDA tensors launch the hand-written kernel (bf16, f16, f32 or int8
    pools; any float q; integer tables and lens) and raise if they
    cannot; CPU tensors run :func:`paged_attention_ref`. Operands
    outside the reference's rule raise :class:`ValueError` with its
    message on either device."""
    _check(q, k_pages, v_pages, block_tables, context_lens)
    s = _scale(scale, q.shape[-1])
    if _on_cpu(q):
        return paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   context_lens, s)
    return _launch(q, k_pages, v_pages, block_tables, context_lens, s)
