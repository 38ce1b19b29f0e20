"""The port's plain rope-fused ragged paged attention against both
reference formulations: the Pallas kernel (interpret mode on the CPU)
and the rope-then-write-then-read ``fused_ragged_paged_attention_xla``.

The same numpy inputs (pools, packed q/k/v, rope tables, row metadata)
go to all three. Outputs must agree at the 1e-5-of-scale bar of
``tests/test_ragged_attention.py``; the written pool slots at the same
bar (the reference jits its rope, where XLA may contract the multiply-
add into an FMA, while PyTorch on the CPU rounds each operation); every
page no row writes must come back bitwise unchanged.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import ragged_paged_attention as RJ

from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import ragged_paged_attention as RT

HK, G, D, PAGE, NUM_PAGES = 2, 2, 16, 8, 40
DUMP = NUM_PAGES - 1


def _case(rng, seqs, qb, inactive=1, poison=False):
    """Row metadata for ``seqs``: a list of (prior context, [chunk
    lengths written this dispatch]). Each sequence gets its own pages;
    its chunks are consecutive rows and consecutive packed tokens."""
    perm = rng.permutation(NUM_PAGES - 1)
    rows, used, t = [], 0, 0
    for prior, chunks in seqs:
        total = prior + sum(chunks)
        pages = perm[used:used + -(-total // PAGE)]
        used += len(pages)
        start = prior
        for c in chunks:
            rows.append((pages, start + c, start, c, prior, t, total))
            start += c
        t += sum(chunks)
    rows += [((), 0, 0, 0, 0, 0, 0)] * inactive
    width = max(len(r[0]) for r in rows) + 2
    tables = np.full((len(rows), width), DUMP, np.int32)
    for i, row in enumerate(rows):
        tables[i, :len(row[0])] = row[0]
        if poison:
            tables[i, len(row[0]):] = rng.choice([-7, 10 ** 6, DUMP + 3],
                                                 width - len(row[0]))
    meta = np.asarray([r[1:] for r in rows], np.int32).T   # [6, R]
    pos = np.concatenate([np.arange(s, s + n) for _, _, s, n, *_ in rows
                          if n > 0]).astype(np.int32)
    sin, cos = (a.numpy() for a in RT.rope_tables(torch.from_numpy(pos),
                                                  D, 10000.0))
    return dict(
        q=rng.randn(t, HK * G, D).astype(np.float32),
        new_k=rng.randn(t, HK, D).astype(np.float32),
        new_v=rng.randn(t, HK, D).astype(np.float32),
        k_pages=rng.randn(NUM_PAGES, HK, PAGE, D).astype(np.float32),
        v_pages=rng.randn(NUM_PAGES, HK, PAGE, D).astype(np.float32),
        block_tables=tables, kv_lens=meta[0], q_starts=meta[1],
        q_lens=meta[2], w_starts=meta[3], w_flats=meta[4], w_ends=meta[5],
        rope_sin=sin, rope_cos=cos, qblock=qb)


ORDER = ("q", "new_k", "new_v", "k_pages", "v_pages", "block_tables",
         "kv_lens", "q_starts", "q_lens", "w_starts", "w_flats", "w_ends")

CASES = {
    # two chunks of one prompt in one dispatch + a decode row + inactive
    "mixed": ([(5, [6, 2]), (9, [1])], 8),
    "all_decode": ([(9, [1]), (31, [1]), (0, [1]), (16, [1])], 1),
    "all_chunks": ([(0, [8, 8, 3]), (4, [5])], 8),
    "long_context": ([(70, [1]), (23, [8, 4])], 8),
    # table tails past the live pages hold out-of-range ids
    "poisoned_tails": ([(5, [6, 2]), (9, [1]), (17, [1])], 8),
}


def _run_torch(c, fn=RT.fused_ragged_paged_attention_ref):
    t = {k: torch.from_numpy(np.array(v)) for k, v in c.items()
         if isinstance(v, np.ndarray)}
    out = fn(*(t[k] for k in ORDER), DUMP, t["rope_sin"], t["rope_cos"],
             c["qblock"])
    return out.numpy(), t["k_pages"].numpy(), t["v_pages"].numpy()


def _run_ref(c, fn):
    args = [jnp.asarray(c[k]) for k in ORDER]
    res = fn(*args, DUMP, rope_sin=jnp.asarray(c["rope_sin"]),
             rope_cos=jnp.asarray(c["rope_cos"]), qblock=c["qblock"])
    return [np.asarray(getattr(a, "_data", a)) for a in res]


def _close(got, want, tol=1e-5):
    scale = max(float(np.abs(want).max()), 1.0)
    assert float(np.abs(got - want).max()) < tol * scale


def _written(c):
    """Boolean [P, page] map of the slots the dispatch writes."""
    w = np.zeros((NUM_PAGES, PAGE), bool)
    tables = np.clip(c["block_tables"], 0, NUM_PAGES - 1)
    for i in range(len(c["kv_lens"])):
        if c["q_lens"][i] <= 0 or c["kv_lens"][i] <= 0:
            continue
        for p in range(c["q_starts"][i], c["q_starts"][i] + c["q_lens"][i]):
            w[tables[i, p // PAGE], p % PAGE] = True
    return w


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("ref", ["pallas_interpret", "xla"])
def test_plain_matches_reference(name, ref):
    seqs, qb = CASES[name]
    c = _case(np.random.RandomState(len(name)), seqs, qb,
              poison=name == "poisoned_tails")
    out, kp, vp = _run_torch(c)
    fn = RJ.fused_ragged_paged_attention if ref == "pallas_interpret" \
        else RJ.fused_ragged_paged_attention_xla
    out_r, kp_r, vp_r = _run_ref(c, fn)
    assert out.shape == out_r.shape == (len(c["kv_lens"]), qb, HK * G, D)
    _close(out, out_r)
    live = np.arange(NUM_PAGES) != DUMP
    _close(kp[live], kp_r[live])
    # V is stored as is; untouched slots are bitwise the input pool
    assert np.array_equal(vp[live], vp_r[live])
    written = _written(c)
    keep = ~written[:, None, :, None] & live[:, None, None, None]
    keep = np.broadcast_to(keep, kp.shape)
    assert np.array_equal(kp[keep], c["k_pages"][keep])
    assert np.array_equal(vp[keep], c["v_pages"][keep])
    # inactive rows and padded query rows are defined zeros
    assert not np.abs(out[-1]).any()
    for i, n in enumerate(c["q_lens"]):
        assert not np.abs(out[i, n:]).any()


def test_cpu_wrapper_is_the_plain_version():
    c = _case(np.random.RandomState(7), *CASES["mixed"])
    before = RT.launches
    got = _run_torch(c, RT.fused_ragged_paged_attention)
    want = _run_torch(c)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert RT.launches == before     # no kernel ran for CPU tensors


def test_wrapper_rejects_bad_shapes():
    c = _case(np.random.RandomState(8), *CASES["mixed"])
    c["rope_sin"] = c["rope_sin"][:-1]
    with pytest.raises(ValueError, match="rope tables"):
        _run_torch(c, RT.fused_ragged_paged_attention)


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(_build.os, "access", lambda *a: False)
    monkeypatch.setattr(_build, "BUILD", "/nonexistent/build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("ragged_paged_attention")
