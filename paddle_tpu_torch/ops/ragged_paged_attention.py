"""Ragged paged attention: one call serves a mixed batch of prefill chunks
and decode rows over a shared paged KV pool (port of
``paddle_tpu/ops/ragged_paged_attention.py``).

Shapes (T packed tokens, R rows, QB the row-block width):

  q             [R, QB, H, D]    row-blocked post-rope queries; entries at
                                 qi >= q_lens[r] are padding (zeros out)
  k/v_pages     [P, Hk, page, D] the pools, head-major (model dtype, or
                                 int8 with scale sidecars)
  k/v_scale     [P, Hk, page, 1] f32 per-(page, head, slot) scales of int8
                                 pools (``quantize_kv_int8``); attention
                                 reads ``int8.float() * scale``
  block_tables  [R, W] int32     page ids of each row's sequence (tail
                                 entries are clamped into [0, P))
  kv_lens       [R] int32        context of the row incl. its queries
                                 (0 marks an inactive row: zeros out)
  q_starts      [R] int32        absolute position of the row's 1st query
  q_lens        [R] int32        valid query tokens of the row
  -> out        [R, QB, H, D]

Row r's query qi attends kv positions ``[0, q_start + qi]`` clipped to
``[0, kv_len)``.

:func:`ragged_paged_attention` only reads the pools (the engine's two-op
path scatters the step's K/V first). :func:`fused_ragged_paged_attention`
also writes the step's K/V: it takes the packed fresh rows
``new_k/new_v [T, Hk, D]`` and per-row write metadata (``w_starts``: the
first position of the row's sequence this dispatch writes, ``w_flats``:
its packed index, ``w_ends``: the sequence's final kv_len), so row r's
token at position p sits at packed index ``w_flats[r] + p - w_starts[r]``.
With ``rope_sin``/``rope_cos`` (``[T, D]`` f32, :func:`rope_tables`) q and
new K arrive PRE-rope, q packed ``[T, H, D]``, and ``qblock`` names the
row-block width; the rotation happens inside the call. Int8 pools are
written as ``quantize_kv_int8`` of the fresh rows (roped and cast to the
model dtype first) into the pool and its sidecars. Pools and sidecars are
updated IN PLACE; the dump page is never written.

On a CUDA tensor the wrappers launch the hand-written kernels in
``csrc/ragged_paged_attention.cu`` (a write launch over the packed
tokens, one warp per fresh K or V vector of a kv head, :func:`write_grid`
and :func:`write_slots`; then the attention launch, on one stream; the
read-only call launches the attention alone).
On a CPU tensor they run the plain versions
(:func:`ragged_paged_attention_ref`,
:func:`fused_ragged_paged_attention_ref`). There is no fallback from one
to the other.

The attention has two instances, picked by one rule on the model dtype
and head_dim (:func:`attention_instance`):

- ``"tensor-core"``: bf16 and f16 models at ``head_dim % 16 == 0`` (over
  float or int8 pools): mma.sync on tensor cores, each row's keys cut
  into splits (:func:`split_plan`) whose partial softmax states the
  last split of each tile to finish merges in split order, in the same
  launch;
- ``"general"``: f32 models and head_dims off multiples of 16 (f32 FMAs
  on CUDA cores).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["rope_tables", "supported", "fused_supported", "check_geometry",
           "attention_instance", "split_plan", "write_grid", "write_slots",
           "fused_rope_geometry_ok",
           "ragged_paged_attention_ref",
           "fused_ragged_paged_attention_ref", "ragged_paged_attention",
           "fused_ragged_paged_attention"]

NEG_INF = -1e30

#: kernel launches on the CUDA path, by the TPU kernel each call replaces:
#: two per fused call (write, then attention), one per read-only call
launches = {"fused_rope": 0, "fused_rope_q8": 0, "fused": 0, "fused_q8": 0,
            "ragged": 0, "ragged_q8": 0}
#: the attention launches by call form and instance
#: (:func:`attention_instance`), keyed ``"<call form>.<instance>"``
instance_launches = {f"{v}.{i}": 0 for v in launches
                     for i in ("tensor-core", "general")}

#: the model dtypes of the CUDA instances (q, fresh K/V, out, float
#: pools), by their C code
_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
_INSTANCES = {"tensor-core": 0, "general": 1}   # the C entry's codes
# the tensor-core instance's work plan (csrc/ragged_paged_attention.cu,
# namespace tc): a block takes TC_TILE_ROWS flattened (token, group head)
# rows of one row and kv head, a busy warp 16 of them, over one split of
# the row's keys of TC_SPLIT_UNIT keys per busy warp (twice that where the
# tile's rows see more than TC_LONG_KEYS keys)
TC_TILE_ROWS = 64
TC_SPLIT_UNIT = 256
TC_LONG_KEYS = 1024
# the write launch's vectors (warps) a block (csrc: kWriteWarps)
WRITE_WARPS = 2


def rope_tables(pos, head_dim, base):
    """Per-dispatch rotary tables, one row per packed token: ``(sin,
    cos)``, each ``[T, D]`` f32 in the neox duplicated-half layout
    (``emb = cat([ang, ang])``). ``pos`` is any integer tensor; it is
    flattened to ``[T]``, and the tables land on its device."""
    inv = 1.0 / (base ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                       device=pos.device) / head_dim))
    ang = pos.reshape(-1).float()[:, None] * inv            # [T, D/2]
    emb = torch.cat([ang, ang], dim=-1)                     # [T, D]
    return emb.sin(), emb.cos()


def fused_rope_geometry_ok(head_dim):
    """Whether the rope-fused call can take this head_dim: the neox
    rotation splits it in half, so it must be even. The serving engine
    demotes ``fused_rope`` to the fused-KV path where it is not."""
    return head_dim % 2 == 0 and head_dim >= 2


def _rot_half(x):
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def _rope(x, sin, cos):
    """``x * cos + rotate_half(x) * sin`` in f32 on ``[T, heads, D]``
    with ``[T, D]`` tables, cast back to ``x.dtype``."""
    xf = x.float()
    out = xf * cos[:, None, :] + _rot_half(xf) * sin[:, None, :]
    return out.to(x.dtype)


def _gather_pages(pages, scales, tables):
    """Every row's pages as one window ``[R, S, Hk, D]``, dequantized
    (``int8.float() * scale``) where ``scales`` is given."""
    x = pages[tables]                                  # [R, W, Hk, page, D]
    if scales is not None:
        x = x.float() * scales[tables].float()
    r, _, hk, _, d = x.shape
    return x.transpose(2, 3).reshape(r, -1, hk, d)


def ragged_paged_attention_ref(q, k_pages, v_pages, block_tables, kv_lens,
                               q_starts, q_lens, scale=None, k_scale=None,
                               v_scale=None):
    """Plain ragged paged attention on row-blocked ``q [R, QB, H, D]``:
    gather every row's pages into a contiguous window (dequantized for
    int8 pools), mask, softmax in f32. Padded query rows and inactive rows
    come back as zeros."""
    r, qb, h, d = q.shape
    p, hk, page_size, _ = k_pages.shape
    group = h // hk
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    dev = q.device
    tables = block_tables.long().clamp(0, p - 1)
    k = _gather_pages(k_pages, k_scale, tables)
    v = _gather_pages(v_pages, v_scale, tables)
    kq = k.repeat_interleave(group, dim=2).float()
    vq = v.repeat_interleave(group, dim=2).float()
    logits = torch.einsum("rqhd,rshd->rhqs", q.float(), kq) * s
    kpos = torch.arange(k.shape[1], device=dev)[None, None, None, :]
    qi = torch.arange(qb, device=dev)[None, :]
    qpos = (q_starts.long()[:, None] + qi)[:, None, :, None]
    qvalid = (qi < q_lens.long()[:, None])[:, None, :, None]
    mask = (kpos <= qpos) & (kpos < kv_lens.long()[:, None, None, None]) \
        & qvalid
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1)
    # fully masked rows (padding, inactive) -> zeros, as the kernel's
    # l == 0 guard gives, not softmax's uniform weights
    w = torch.where(mask.any(dim=-1, keepdim=True), w, torch.zeros_like(w))
    out = torch.einsum("rhqs,rshd->rqhd", w, vq)
    return out.to(q.dtype)


def fused_ragged_paged_attention_ref(q, new_k, new_v, k_pages, v_pages,
                                     block_tables, kv_lens, q_starts, q_lens,
                                     w_starts, w_flats, w_ends, dump_page,
                                     scale=None, k_scale=None, v_scale=None,
                                     rope_sin=None, rope_cos=None,
                                     qblock=None):
    """The plain version: with rope tables, rope the packed q and new K
    and gather q into ``[R, qblock]`` row blocks; write every active
    row's fresh K/V into its pages (in place; int8 pools get
    ``quantize_kv_int8`` of them and their scales), then
    :func:`ragged_paged_attention_ref` over the updated pools.
    ``w_ends`` and ``dump_page`` are accepted for signature parity; the
    dump page is never touched."""
    # the inference package imports this module
    from ..inference.paged_cache import quantize_kv_int8
    del w_ends, dump_page
    if rope_sin is not None:
        sin, cos = rope_sin.float(), rope_cos.float()
        q_rows = _rope(q, sin, cos)
        new_k = _rope(new_k, sin, cos)
        qr = q_rows.new_zeros((block_tables.shape[0], int(qblock))
                              + tuple(q_rows.shape[1:]))
    else:
        qr = q
    quant = k_scale is not None
    if quant:
        new_k, k_sc = quantize_kv_int8(new_k)
        new_v, v_sc = quantize_kv_int8(new_v)
    page_size = k_pages.shape[2]
    tables = block_tables.long().clamp(0, k_pages.shape[0] - 1)
    meta = torch.stack([m.long() for m in (kv_lens, q_starts, q_lens,
                                           w_starts, w_flats)]).tolist()
    hidx = torch.arange(k_pages.shape[1], device=q.device)[None, :]
    for i, (kv, qs, n, ws, wf) in enumerate(zip(*meta)):
        if n <= 0:
            continue
        f0 = wf + qs - ws
        if rope_sin is not None:
            qr[i, :n] = q_rows[f0:f0 + n]
        if kv <= 0:
            continue
        pos = torch.arange(qs, qs + n, device=q.device)
        pages = tables[i, pos // page_size][:, None]
        offs = (pos % page_size)[:, None]
        k_pages[pages, hidx, offs] = new_k[f0:f0 + n].to(k_pages.dtype)
        v_pages[pages, hidx, offs] = new_v[f0:f0 + n].to(v_pages.dtype)
        if quant:
            k_scale[pages, hidx, offs, 0] = k_sc[f0:f0 + n]
            v_scale[pages, hidx, offs, 0] = v_sc[f0:f0 + n]
    return ragged_paged_attention_ref(qr, k_pages, v_pages, tables, kv_lens,
                                      q_starts, q_lens, scale, k_scale,
                                      v_scale)


# ----------------------------------------------------------------------
# shape contract: one checker per call; `supported` / `fused_supported`
# are the same checks returning a bool
# ----------------------------------------------------------------------

def _check_pools(k_pages, v_pages, k_scale, v_scale):
    if k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError("pools must be [P, Hk, page, D], K and V alike; "
                         f"got {tuple(k_pages.shape)}/{tuple(v_pages.shape)}")
    p, hk, page_size, d = k_pages.shape
    if hk == 0 or d % 8 or d > 256 or page_size % 8:
        raise ValueError(f"pools need page % 8 == 0, D % 8 == 0, D <= 256; "
                         f"got page {page_size}, D {d}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("int8 pools need both k_scale and v_scale")
    if v_pages.dtype != k_pages.dtype \
            or (k_pages.dtype == torch.int8) != (k_scale is not None):
        raise ValueError(
            "pools are float without sidecars, or int8 pools with scales "
            f"(k_scale, v_scale); got {k_pages.dtype}/{v_pages.dtype} pools "
            + ("with" if k_scale is not None else "without") + " scales")
    if k_scale is not None:
        want = (p, hk, page_size, 1)
        if tuple(k_scale.shape) != want or tuple(v_scale.shape) != want:
            raise ValueError(f"scale sidecars must be [P, Hk, page, 1] = "
                             f"{want}")


def _check_rows(r, block_tables, meta, tensors):
    if block_tables.dim() != 2 or block_tables.shape[0] != r \
            or any(tuple(m.shape) != (r,) for m in meta):
        raise ValueError("block_tables must be [R, W] and the per-row "
                         "metadata [R]")
    devs = {a.device for a in tensors if a is not None}
    if len(devs) != 1:
        raise ValueError(f"all operands must share one device, got {devs}")


def _check_ragged(q, k_pages, v_pages, block_tables, meta, k_scale, v_scale):
    _check_pools(k_pages, v_pages, k_scale, v_scale)
    if q.dim() != 4:
        raise ValueError(f"q must be [R, QB, H, D], got {tuple(q.shape)}")
    r, qb, h, d = q.shape
    hk = k_pages.shape[1]
    if d != k_pages.shape[3] or h % hk or qb < 1:
        raise ValueError(f"inconsistent shapes: q {tuple(q.shape)}, pools "
                         f"{tuple(k_pages.shape)}")
    _check_rows(r, block_tables, meta, (q, k_pages, v_pages, block_tables,
                                        k_scale, v_scale, *meta))
    if not _on_cpu(q):
        _check_kernel(q, k_pages, v_pages, k_scale, v_scale,
                      (block_tables, *meta))


def _check_fused(q, new_k, new_v, k_pages, v_pages, block_tables, meta,
                 dump_page, k_scale, v_scale, rope_sin, rope_cos, qblock):
    _check_pools(k_pages, v_pages, k_scale, v_scale)
    p, hk, _, d = k_pages.shape
    r = block_tables.shape[0] if block_tables.dim() == 2 else -1
    if new_k.dim() != 3 or new_v.shape != new_k.shape \
            or tuple(new_k.shape[1:]) != (hk, d) or new_k.shape[0] < 1:
        raise ValueError(f"new_k/new_v must be [T, Hk, D] = [T, {hk}, {d}] "
                         f"with T >= 1; got {tuple(new_k.shape)}/"
                         f"{tuple(new_v.shape)}")
    t = new_k.shape[0]
    if (rope_sin is None) != (rope_cos is None):
        raise ValueError("pass both rope tables or neither")
    if rope_sin is not None:
        if q.dim() != 3 or q.shape[0] != t or q.shape[2] != d \
                or q.shape[1] % hk or qblock is None or int(qblock) < 1 \
                or not fused_rope_geometry_ok(d):
            raise ValueError(
                f"the rope-fused call takes packed q [T, H, D] = [{t}, H, "
                f"{d}] (H % Hk == 0, D even) and qblock >= 1; got q "
                f"{tuple(q.shape)}, qblock {qblock}")
        if tuple(rope_sin.shape) != (t, d) \
                or tuple(rope_cos.shape) != (t, d):
            raise ValueError(f"rope tables must be [T, D] = {(t, d)}")
    elif q.dim() != 4 or q.shape[0] != r or q.shape[3] != d \
            or q.shape[2] % hk or q.shape[1] < 1:
        raise ValueError(f"q must be [R, QB, H, D] with R = {r}, D = {d}, "
                         f"H % Hk == 0; got {tuple(q.shape)}")
    try:
        dp = int(dump_page)
    except (TypeError, ValueError):
        dp = -1
    if not 0 <= dp < p:
        raise ValueError(f"dump_page must be a page id in [0, {p}), got "
                         f"{dump_page!r}")
    _check_rows(r, block_tables, meta,
                (q, new_k, new_v, k_pages, v_pages, block_tables, k_scale,
                 v_scale, rope_sin, rope_cos, *meta))
    if not _on_cpu(q):
        # the kernels read every row operand but w_ends
        _check_kernel(q, k_pages, v_pages, k_scale, v_scale,
                      (block_tables, *meta[:5]), (new_k, new_v),
                      (rope_sin, rope_cos) if rope_sin is not None else (),
                      written=True)


def check_geometry(page_size, head_dim, dtype, kv_int8=False):
    """The CUDA kernels' rule on a serving geometry, the same as the
    reference's: ``page_size % 8 == 0``, ``head_dim % 8 == 0`` up to 256,
    and a model dtype of bf16, f16 or f32 (float pools in it, or int8
    pools). Shared memory forces no further bound (both attention
    instances walk the keys in steps of a fixed size, whatever the
    page). Raises :class:`ValueError`; :class:`LlamaServingEngine` calls
    it at construction."""
    if dtype not in _DTYPES:
        raise ValueError(
            f"the CUDA kernels take a bfloat16, float16 or float32 model "
            f"(q, fresh K/V, float pools); got {dtype}")
    if page_size % 8 or page_size < 8 or head_dim % 8 or not \
            8 <= head_dim <= 256:
        raise ValueError(
            f"the CUDA kernels take page_size % 8 == 0 and head_dim % 8 == "
            f"0 up to 256; got page_size {page_size}, head_dim {head_dim}"
            + (" (int8 pools)" if kv_int8 else ""))


def attention_instance(dtype, head_dim, kv_dtype=None):
    """The CUDA attention instance that takes a model (q) of ``dtype``
    at ``head_dim`` (:func:`check_geometry`'s domain) over pools of
    ``kv_dtype`` (default: the model's; int8 pools count as the
    model's): ``"tensor-core"`` for bf16 and f16 at ``head_dim % 16 ==
    0`` over pools of the model's dtype or int8 (mma.sync, the keys split
    over the sequence), ``"general"`` (f32 FMAs) for f32 models, head_dims
    off multiples of 16, and float pools of another dtype than the
    model's. Raises :class:`ValueError` outside the domain."""
    check_geometry(8, head_dim, dtype)
    mixed = kv_dtype not in (None, torch.int8, dtype)
    if dtype in (torch.bfloat16, torch.float16) and head_dim % 16 == 0 \
            and not mixed:
        return "tensor-core"
    return "general"


def _check_instance(instance, dtype, head_dim, kv_dtype=None):
    """Refuse a launch of ``instance`` on any pairing the rule of
    :func:`attention_instance` does not give it."""
    want = attention_instance(dtype, head_dim, kv_dtype)
    if instance != want:
        raise ValueError(
            f"the {instance} attention instance does not take a {dtype} "
            f"model at head_dim {head_dim} over {kv_dtype or dtype} pools "
            f"(the rule gives {want})")
    return _INSTANCES[instance]


def split_plan(kv_len, q_len, q_start, group, qblock, width, page_size):
    """The tensor-core instance's work on one row, the rule the CUDA
    kernels apply: ``[(tile, n_valid, [(k_lo, k_hi), ...]), ...]`` for
    each tile of ``TC_TILE_ROWS`` flattened (query token, group head)
    rows that holds a valid row; ``n_valid`` of its rows are valid, and
    the splits cut the keys ``[0, n_keys)`` its rows see (``n_keys``:
    the tile's last query's causal horizon, clipped to ``kv_len`` and
    the table's ``width * page_size`` slots) into runs of
    ``TC_SPLIT_UNIT`` keys per 16 valid rows, twice that past
    ``TC_LONG_KEYS`` keys. It reads the row's own
    metadata and the geometry only, never another row or the card, so a
    row's output does not depend on what else a dispatch holds."""
    rows = min(q_len, qblock) * group if kv_len > 0 and q_len > 0 else 0
    plan = []
    for tile in range(-(-rows // TC_TILE_ROWS)):
        n_valid = min(TC_TILE_ROWS, rows - tile * TC_TILE_ROWS)
        last_q = (tile * TC_TILE_ROWS + n_valid - 1) // group
        n_keys = max(0, min(kv_len, q_start + last_q + 1,
                            width * page_size))
        split = TC_SPLIT_UNIT * -(-n_valid // 16) \
            * (2 if n_keys > TC_LONG_KEYS else 1)
        plan.append((tile, n_valid, [(lo, min(lo + split, n_keys))
                                     for lo in range(0, n_keys, split)]))
    return plan


def write_grid(n_tok, num_kv_heads):
    """Blocks of the CUDA write launch: one warp per (fresh token, kv
    head, K or V) vector, WRITE_WARPS vectors a block; a function of the
    packed token count and the kv heads only, never of the rows."""
    return -(-2 * n_tok * num_kv_heads // WRITE_WARPS)


def write_slots(n_tok, block_tables, kv_lens, q_starts, q_lens, w_starts,
                w_flats, num_pages, page_size):
    """The write launch's map, the rule the CUDA kernel applies to each
    packed token ``f < n_tok`` (the same for every kv head and for K and
    V): the rows that hold it (an active row, ``q_lens > 0`` and
    ``kv_lens > 0``, holds packed tokens ``[w_flats + q_starts -
    w_starts, + q_lens)``) and, for each, the (page, slot) its position
    ``q_starts + t`` lands in, the table entry clamped into ``[0,
    num_pages)``; positions past the table are skipped. Returns ``{f:
    [(row, page, slot), ...]}`` for the tokens some row holds; a padding
    token is in none."""
    meta = [m.tolist() for m in (kv_lens, q_starts, q_lens, w_starts,
                                 w_flats)]
    tables = block_tables.tolist()
    width = len(tables[0]) if tables else 0
    plan = {}
    for f in range(n_tok):
        for r, (kv, qs, ql, ws, wf) in enumerate(zip(*meta)):
            t = f - (wf + qs - ws)
            if ql <= 0 or kv <= 0 or not 0 <= t < ql:
                continue
            pos = qs + t
            pi = pos // page_size
            if pos < 0 or pi >= width:
                continue
            page = min(max(tables[r][pi], 0), num_pages - 1)
            plan.setdefault(f, []).append((r, page, pos - pi * page_size))
    return plan


def tc_scratch_rows(width, page_size):
    """Rows of one (row, kv head, tile) slab of the tensor-core
    instance's partial buffers: every split of every valid row of a tile
    fits, since a split holds at least 16 keys per valid row."""
    return -(-width * page_size // 16) + TC_TILE_ROWS


def _check_kernel(q, k_pages, v_pages, k_scale, v_scale, rows, fresh=(),
                  tables=(), written=False):
    """The kernels' own limits on CUDA operands, past the contract
    (:func:`_check_pools` ties int8 pools to their sidecars): the
    geometry of :func:`check_geometry`; q, fresh K/V and float pools in
    bf16, f16 or f32 (of any mix); integer rows, float scales and rope
    tables. The launch converts the rest as the reference does
    (:func:`_readable`). What it cannot convert, it refuses: pools and
    sidecars that a fused call writes in place (``written``) must be
    contiguous and 16-byte aligned, the sidecars f32; the rope-fused call
    reads fresh K and V as one dtype (V in K's, exactly: K's dtype is
    V's or f32)."""
    q8 = k_scale is not None
    p, hk, page_size, d = k_pages.shape
    check_geometry(page_size, d, q.dtype, q8)
    floats = (*fresh, *((k_pages,) if not q8 else ()))
    if any(a.dtype not in _DTYPES for a in floats):
        raise ValueError(
            "the CUDA kernels take q, fresh K/V and float pools in "
            "bfloat16, float16 or float32 (any mix), or int8 pools with "
            f"scales; got q {q.dtype}, pools {k_pages.dtype}"
            + (f", fresh {fresh[0].dtype}/{fresh[1].dtype}" if fresh else ""))
    if tables and fresh[1].dtype != fresh[0].dtype \
            and fresh[0].dtype != torch.float32:
        raise ValueError(
            "the rope-fused call reads fresh K and V as one dtype: V in "
            f"K's ({fresh[0].dtype}) exactly, so K must be V's dtype or "
            f"float32; got V {fresh[1].dtype}")
    if any(a.dtype.is_floating_point or a.dtype.is_complex
           or a.dtype == torch.bool for a in rows):
        raise ValueError("block tables and row metadata must be integers")
    if any(not a.dtype.is_floating_point
           for a in (*tables, *((k_scale, v_scale) if q8 else ()))):
        raise ValueError("scale sidecars and rope tables must be floats")
    if written:
        pools = (k_pages, v_pages) + ((k_scale, v_scale) if q8 else ())
        if q8 and (k_scale.dtype != torch.float32
                   or v_scale.dtype != torch.float32):
            raise ValueError(
                "a fused call writes the scale sidecars in place, so it "
                "takes float32 sidecars (it cannot convert them)")
        if not all(a.is_contiguous() for a in pools) \
                or any(a.data_ptr() % 16 for a in pools):
            raise ValueError(
                "a fused call writes the pools and sidecars in place, so it "
                "takes them contiguous and 16-byte aligned (it cannot copy "
                "them)")


def _readable(t, dtype=None, align=True):
    """``t`` as a kernel reads it: in ``dtype`` (if given), contiguous,
    16-byte aligned where ``align`` (the operands read as 16-byte
    vectors); a copy only where ``t`` is not. For operands the kernels
    only read: q, rows, fresh K/V, read-only pools, sidecars and rope
    tables."""
    if t is None:
        return None
    if dtype is not None:
        t = t.to(dtype)
    t = t.contiguous()
    return t if not align or t.data_ptr() % 16 == 0 else t.clone()


def _passes(check, *args):
    try:
        check(*args)
    except ValueError:
        return False
    return True


def supported(q, k_pages, v_pages, block_tables, kv_lens, q_starts, q_lens,
              k_scale=None, v_scale=None):
    """Whether :func:`ragged_paged_attention` takes these operands (the
    reference's shape contract; CUDA tensors must also fit the kernel's
    own limits, :func:`_check_kernel`)."""
    return _passes(_check_ragged, q, k_pages, v_pages, block_tables,
                   (kv_lens, q_starts, q_lens), k_scale, v_scale)


def fused_supported(q, new_k, new_v, k_pages, v_pages, block_tables,
                    kv_lens, q_starts, q_lens, w_starts, w_flats, w_ends,
                    dump_page, k_scale=None, v_scale=None, rope_sin=None,
                    rope_cos=None, qblock=None):
    """Whether :func:`fused_ragged_paged_attention` takes these operands:
    :func:`supported`'s contract, packed ``new_k/new_v [T, Hk, D]`` (T >=
    1), write metadata ``[R]`` and a dump page inside the pool; with rope
    tables, packed q ``[T, H, D]``, tables ``[T, D]`` and ``qblock``."""
    return _passes(_check_fused, q, new_k, new_v, k_pages, v_pages,
                   block_tables, (kv_lens, q_starts, q_lens, w_starts,
                                  w_flats, w_ends), dump_page, k_scale,
                   v_scale, rope_sin, rope_cos, qblock)


# ----------------------------------------------------------------------
# the CUDA launches
# ----------------------------------------------------------------------

def _lib():
    lib = _build.load("ragged_paged_attention")
    if not getattr(lib, "_rpa_typed", False):
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.rpa_kv_write.argtypes = [i32] * 4 + [vp] * 14 + [i32] * 7 + [vp]
        lib.rpa_kv_write.restype = i32
        lib.rpa_attention.argtypes = [i32] * 5 + [vp] * 17 + [i32] * 10 \
            + [ctypes.c_float, vp]
        lib.rpa_attention.restype = i32
        lib.rpa_error_string.argtypes = [i32]
        lib.rpa_error_string.restype = ctypes.c_char_p
        lib._rpa_typed = True
    return lib


def _raise_on(lib, rc, what):
    if rc:
        msg = lib.rpa_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def _pool_code(k_pages):
    """The C code of float pools (int8 pools: 0, unread)."""
    return _DTYPES.get(k_pages.dtype, 0)


def _attend(lib, rope, q, k_pages, v_pages, k_scale, v_scale, sin, cos,
            block_tables, meta, n_tok, qb, scale, what):
    """The attention launch; ``meta`` is (kv_lens, q_starts, q_lens,
    w_starts, w_flats), the last two None without rope."""
    r, w = block_tables.shape
    h, d = q.shape[-2:]
    p, hk, page_size, _ = k_pages.shape
    inst = attention_instance(q.dtype, d, k_pages.dtype)
    code = _check_instance(inst, q.dtype, d, k_pages.dtype)
    out = torch.empty((r, qb, h, d), dtype=q.dtype, device=q.device)
    if r == 0:
        return out
    part_o = part_ml = tickets = None
    slab = 0
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if inst == "tensor-core":
        # the splits' partial accumulators and (max, sum) pairs, and a
        # ticket a tile
        tiles = -(-qb * (h // hk) // TC_TILE_ROWS)
        slab = tc_scratch_rows(w, page_size)
        n = r * hk * tiles * slab
        part_o = torch.empty((n * d,), dtype=torch.float32, device=q.device)
        part_ml = torch.empty((n * 2,), dtype=torch.float32,
                              device=q.device)
        tickets = _build.tickets(q.device, r * hk * tiles)
    ptrs = (q, k_pages, v_pages, k_scale, v_scale, sin, cos, block_tables,
            *meta, out, part_o, part_ml, tickets)
    rc = lib.rpa_attention(code, _DTYPES[q.dtype], _pool_code(k_pages),
                           int(rope), int(k_scale is not None),
                           *map(_build.data_ptr, ptrs), r, n_tok, h, hk, d,
                           p, page_size, w, qb, slab, float(scale), stream)
    _raise_on(lib, rc, what)
    launches[what] += 1
    instance_launches[f"{what}.{inst}"] += 1
    return out


def _launch_ragged(q, k_pages, v_pages, block_tables, meta, scale, k_scale,
                   v_scale):
    what = "ragged_q8" if k_scale is not None else "ragged"
    # read only: every operand may be converted or copied
    q, k_pages, v_pages = map(_readable, (q, k_pages, v_pages))
    k_scale, v_scale = (_readable(x, torch.float32)
                        for x in (k_scale, v_scale))
    block_tables, *meta = (_readable(x, torch.int32, align=False)
                           for x in (block_tables, *meta))
    return _attend(_lib(), False, q, k_pages, v_pages, k_scale, v_scale,
                   None, None, block_tables, tuple(meta) + (None, None), 0,
                   q.shape[1], scale, what)


def _fused_form(rope_sin, k_scale):
    return ("fused_rope" if rope_sin is not None else "fused") \
        + ("_q8" if k_scale is not None else "")


def _fresh(new_k, new_v, k_pages, rope):
    """The fresh K/V as the write launch reads them, cast where the
    reference casts them. Without rope: both in the float pools' dtype,
    or in f32 (exact) over int8 pools where their dtypes differ. With
    rope, K stays in its own dtype (it is roped and cast through it
    before the pools' cast or quantizer) and V is read in K's, which
    :func:`_check_kernel` lets through only where it is exact (V in K's
    dtype already, or K in f32); the kernel casts both to float pools'
    dtype."""
    if not rope:
        dt = k_pages.dtype if k_pages.dtype != torch.int8 else (
            new_k.dtype if new_v.dtype == new_k.dtype else torch.float32)
        new_k, new_v = new_k.to(dt), new_v.to(dt)
    else:
        new_v = new_v.to(new_k.dtype)
    return _readable(new_k), _readable(new_v)


def _launch_write(lib, new_k, new_v, k_pages, v_pages, block_tables, meta,
                  k_scale, v_scale, rope_sin, rope_cos):
    """The write launch of a fused call (``meta``: kv_lens, q_starts,
    q_lens, w_starts, w_flats); counted in ``launches`` under the call
    form."""
    r, w = block_tables.shape
    t = new_k.shape[0]
    p, hk, page_size, d = k_pages.shape
    what = _fused_form(rope_sin, k_scale)
    ptrs = (new_k, new_v, k_pages, v_pages, k_scale, v_scale, rope_sin,
            rope_cos, block_tables, *meta)
    rc = lib.rpa_kv_write(_DTYPES[new_k.dtype], _pool_code(k_pages),
                          int(rope_sin is not None),
                          int(k_scale is not None),
                          *map(_build.data_ptr, ptrs), r, t, hk, d, p,
                          page_size, w,
                          torch.cuda.current_stream(new_k.device).cuda_stream)
    _raise_on(lib, rc, what + " write")
    launches[what] += 1


def _launch_fused(q, new_k, new_v, k_pages, v_pages, block_tables, meta,
                  scale, k_scale, v_scale, rope_sin, rope_cos, qblock):
    rope = rope_sin is not None
    what = _fused_form(rope_sin, k_scale)
    lib = _lib()
    qb = int(qblock) if rope else q.shape[1]
    # the pools and sidecars are written in place (checked, never
    # copied); every other operand is read only
    q = _readable(q)
    new_k, new_v = _fresh(new_k, new_v, k_pages, rope)
    rope_sin, rope_cos = (_readable(x, torch.float32)
                          for x in (rope_sin, rope_cos))
    block_tables, *meta = (_readable(x, torch.int32, align=False)
                           for x in (block_tables, *meta))
    if block_tables.shape[0]:
        _launch_write(lib, new_k, new_v, k_pages, v_pages, block_tables,
                      meta, k_scale, v_scale, rope_sin, rope_cos)
    # the attention reads the written pools, so it needs no fresh rows
    return _attend(lib, rope, q, k_pages, v_pages, k_scale, v_scale,
                   rope_sin, rope_cos, block_tables,
                   tuple(meta) if rope else tuple(meta[:3]) + (None, None),
                   new_k.shape[0], qb, scale, what)


def _scale(scale, d):
    return scale if scale is not None else 1.0 / math.sqrt(d)


def _on_cpu(t):
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return False


def ragged_paged_attention(q, k_pages, v_pages, block_tables, kv_lens,
                           q_starts, q_lens, scale=None, k_scale=None,
                           v_scale=None):
    """Ragged paged attention over the pools, read only (see the module
    docstring for shapes). Pass ``k_scale``/``v_scale`` sidecars with
    int8 pools. Returns ``out [R, QB, H, D]``.

    CUDA tensors launch the hand-written attention kernel (q and float
    pools in bf16, f16 or f32, any mix, or int8 pools with float
    sidecars; integer rows; operands converted and copied as
    :func:`_readable` says) and raise if they cannot;
    CPU tensors run :func:`ragged_paged_attention_ref`."""
    meta = (kv_lens, q_starts, q_lens)
    _check_ragged(q, k_pages, v_pages, block_tables, meta, k_scale, v_scale)
    s = _scale(scale, q.shape[-1])
    if _on_cpu(q):
        return ragged_paged_attention_ref(q, k_pages, v_pages, block_tables,
                                          kv_lens, q_starts, q_lens, s,
                                          k_scale, v_scale)
    return _launch_ragged(q, k_pages, v_pages, block_tables, meta, s,
                          k_scale, v_scale)


def fused_ragged_paged_attention(q, new_k, new_v, k_pages, v_pages,
                                 block_tables, kv_lens, q_starts, q_lens,
                                 w_starts, w_flats, w_ends, dump_page,
                                 scale=None, k_scale=None, v_scale=None,
                                 rope_sin=None, rope_cos=None, qblock=None):
    """KV page write + ragged paged attention in one call (see the
    module docstring for shapes): with rope tables, q and new K are
    pre-rope and packed, else q is row-blocked post-rope. Returns ``out
    [R, QB, H, D]``; the fresh K/V (quantized for int8 pools, with their
    scales) land in the pools IN PLACE; the dump page is never written.

    CUDA tensors launch the hand-written write and attention kernels
    (q, fresh K/V and float pools in bf16, f16 or f32, any mix, or int8
    pools; the read-only operands converted as the reference converts
    them; the pools and f32 sidecars, written in place, contiguous and
    16-byte aligned, :func:`_check_kernel`) and raise if they cannot;
    CPU tensors, of any float dtype, run
    :func:`fused_ragged_paged_attention_ref`."""
    meta = (kv_lens, q_starts, q_lens, w_starts, w_flats)
    _check_fused(q, new_k, new_v, k_pages, v_pages, block_tables,
                 meta + (w_ends,), dump_page, k_scale, v_scale, rope_sin,
                 rope_cos, qblock)
    s = _scale(scale, q.shape[-1])
    if _on_cpu(q):
        return fused_ragged_paged_attention_ref(
            q, new_k, new_v, k_pages, v_pages, block_tables, kv_lens,
            q_starts, q_lens, w_starts, w_flats, w_ends, dump_page, s,
            k_scale, v_scale, rope_sin, rope_cos, qblock)
    return _launch_fused(q, new_k, new_v, k_pages, v_pages, block_tables,
                         meta, s, k_scale, v_scale, rope_sin, rope_cos,
                         qblock)
