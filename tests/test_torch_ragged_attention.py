"""The port's plain ragged paged attention family against both
reference formulations: the Pallas kernels (interpret mode on the CPU)
and the write-then-read ``*_xla`` compositions.

The same numpy inputs (pools, packed or row-blocked q, new k/v, rope
tables, row metadata, int8 pools with their scale sidecars) go to all
three. Outputs must agree at the 1e-5-of-scale bar of
``tests/test_ragged_attention.py``; written bf16-or-f32 K slots at the
same bar (the reference jits its rope, where XLA may contract the
multiply-add into an FMA, while PyTorch on the CPU rounds each
operation); written V slots, int8 slots and their scales bit for bit;
every slot no row writes must come back bitwise unchanged. The dump page
is excluded: the Pallas kernels leave it undefined.

The variants, by the TPU kernel each plain path stands for: #12
rope-fused, #13 rope-fused int8, #11a fused post-rope, #11b fused
post-rope int8, #10 read-only, #9 read-only int8.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import ragged_paged_attention as RJ

from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import ragged_paged_attention as RT

# One intra-op thread a process: the suite runs in parallel worker
# processes (xdist), and OpenMP threads that spin for a core each
# slow every small CPU op of the port many times over.
torch.set_num_threads(1)

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


def _run_torch(c, fn=RT.fused_ragged_paged_attention_ref, rope=True):
    """``fn`` on torch copies of the case's arrays; returns numpy (out,
    k_pages, v_pages[, k_scale, v_scale])."""
    t = {k: torch.from_numpy(np.array(v)) for k, v in c.items()
         if isinstance(v, np.ndarray)}
    kw = dict(rope_sin=t["rope_sin"], rope_cos=t["rope_cos"],
              qblock=c["qblock"]) if rope else {}
    if "k_scale" in t:
        kw.update(k_scale=t["k_scale"], v_scale=t["v_scale"])
    out = fn(*(t[k] for k in ORDER), DUMP, **kw)
    pools = ("k_pages", "v_pages") + (("k_scale", "v_scale")
                                      if "k_scale" in t else ())
    return (out.numpy(),) + tuple(t[k].numpy() for k in pools)


def _run_ref(c, fn, rope=True):
    args = [jnp.asarray(c[k]) for k in ORDER]
    kw = dict(rope_sin=jnp.asarray(c["rope_sin"]),
              rope_cos=jnp.asarray(c["rope_cos"]),
              qblock=c["qblock"]) if rope else {}
    if "k_scale" in c:
        kw.update(k_scale=jnp.asarray(c["k_scale"]),
                  v_scale=jnp.asarray(c["v_scale"]))
    res = fn(*args, DUMP, **kw)
    return [np.asarray(getattr(a, "_data", a)) for a in res]


def _row_blocked(c):
    """The case with q gathered from the packed ``[T, H, D]`` layout into
    ``[R, qblock, H, D]`` row blocks (post-rope q for #11a/#11b, #9/#10)."""
    c = dict(c)
    qr = np.zeros((len(c["kv_lens"]), c["qblock"]) + c["q"].shape[1:],
                  np.float32)
    for i, n in enumerate(c["q_lens"]):
        f0 = c["w_flats"][i] + c["q_starts"][i] - c["w_starts"][i]
        qr[i, :n] = c["q"][f0:f0 + n]
    c["q"] = qr
    return c


def _int8_pools(c, rng):
    """The case with int8 pools and positive f32 scale sidecars."""
    c = dict(c)
    shape = c["k_pages"].shape
    for name in ("k", "v"):
        c[f"{name}_pages"] = rng.randint(-127, 128, shape).astype(np.int8)
        c[f"{name}_scale"] = (rng.rand(*shape[:3], 1) * 0.05
                              + 1e-3).astype(np.float32)
    return c


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
    before = dict(RT.launches)
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


def _unchanged(c, got, keep):
    """Slots no row writes (and every sidecar entry of them) come back
    bitwise the input."""
    for name, arr in zip(("k_pages", "v_pages", "k_scale", "v_scale"),
                         got[1:]):
        k = np.broadcast_to(keep[..., :arr.shape[-1]], arr.shape)
        assert np.array_equal(arr[k], c[name][k]), name


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("ref", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("variant", ["fused_rope_q8", "fused", "fused_q8"])
def test_fused_variants_match_reference(name, ref, variant):
    """#13, #11a and #11b: out at 1e-5 of scale; written V slots, int8
    slots and scales bit for bit, except after rope: float K slots at
    1e-5 and, for #13, K scales within one f32 ulp (the reference's rope
    may contract into an FMA, so the f32 absmax of a roped row can move
    by an ulp); unwritten slots and sidecars unchanged."""
    seqs, qb = CASES[name]
    rng = np.random.RandomState(len(name) + len(variant))
    c = _case(rng, seqs, qb, poison=name == "poisoned_tails")
    rope = variant.startswith("fused_rope")
    if not rope:
        c = _row_blocked(c)
    if variant.endswith("q8"):
        c = _int8_pools(c, rng)
    got = _run_torch(c, rope=rope)
    fn = RJ.fused_ragged_paged_attention if ref == "pallas_interpret" \
        else RJ.fused_ragged_paged_attention_xla
    want = _run_ref(c, fn, rope=rope)
    assert len(got) == len(want)
    assert got[0].shape == want[0].shape == (len(c["kv_lens"]), qb, HK * G,
                                             D)
    _close(got[0], want[0])
    live = np.arange(NUM_PAGES) != DUMP
    if variant.endswith("q8"):
        for i, (g, w) in enumerate(zip(got[1:], want[1:])):
            assert g.dtype == w.dtype
            g, w = g[live], w[live]
            if rope and i == 2:                   # K scales after rope
                assert (np.abs(g - w) <= np.spacing(w)).all()
            else:
                assert np.array_equal(g, w)
    else:
        _close(got[1][live], want[1][live])
        assert np.array_equal(got[2][live], want[2][live])
    keep = ~_written(c)[:, None, :, None] & live[:, None, None, None]
    _unchanged(c, got, keep)
    assert not np.abs(got[0][-1]).any()
    for i, n in enumerate(c["q_lens"]):
        assert not np.abs(got[0][i, n:]).any()


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("ref", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("q8", [False, True], ids=["bf16_pools",
                                                   "int8_pools"])
def test_read_only_matches_reference(name, ref, q8):
    """#10 and #9: the read-only call over pools written before, with and
    without sidecars, at 1e-5 of scale; nothing is written."""
    seqs, qb = CASES[name]
    rng = np.random.RandomState(3 * len(name) + q8)
    c = _row_blocked(_case(rng, seqs, qb, poison=name == "poisoned_tails"))
    if q8:
        c = _int8_pools(c, rng)
    t = {k: torch.from_numpy(np.array(v)) for k, v in c.items()
         if isinstance(v, np.ndarray)}
    args = ("q", "k_pages", "v_pages", "block_tables", "kv_lens",
            "q_starts", "q_lens")
    kw = dict(k_scale=t["k_scale"], v_scale=t["v_scale"]) if q8 else {}
    before = dict(RT.launches)
    got = RT.ragged_paged_attention(*(t[k] for k in args), **kw).numpy()
    assert RT.launches == before
    plain = RT.ragged_paged_attention_ref(*(t[k] for k in args), **kw)
    assert np.array_equal(got, plain.numpy())
    fn = RJ.ragged_paged_attention if ref == "pallas_interpret" \
        else RJ.ragged_paged_attention_xla
    jkw = {k: jnp.asarray(c[k]) for k in ("k_scale", "v_scale")} if q8 \
        else {}
    want = np.asarray(getattr(r := fn(*(jnp.asarray(c[k]) for k in args),
                                      **jkw), "_data", r))
    _close(got, want)
    for k in ("k_pages", "v_pages") + (("k_scale", "v_scale") if q8
                                        else ()):
        assert np.array_equal(t[k].numpy(), c[k])
    assert not np.abs(got[-1]).any()


@pytest.mark.parametrize("fused", [False, True], ids=["read_only",
                                                      "fused_rope"])
def test_reference_operand_forms_match_reference(fused):
    """C9's forms the reference converts (int64 row metadata; bf16
    read-only scale sidecars; f64 rope tables) give the reference's
    results: the read-only int8 call (#9) and the rope-fused call (#12)
    against the Pallas kernels in interpret mode, at 1e-5 of scale."""
    seqs, qb = CASES["mixed"]
    rng = np.random.RandomState(21 + fused)
    c = _case(rng, seqs, qb)
    ints = ("block_tables", "kv_lens", "q_starts", "q_lens", "w_starts",
            "w_flats", "w_ends")
    if not fused:
        c = _int8_pools(_row_blocked(c), rng)
        # sidecars as bf16 holds them: both sides read the same values
        for k in ("k_scale", "v_scale"):
            c[k] = np.asarray(jnp.asarray(c[k], jnp.bfloat16), np.float32)
    t = {k: torch.from_numpy(np.array(v)) for k, v in c.items()
         if isinstance(v, np.ndarray)}
    for k in ints:
        t[k] = t[k].long()
    j = {k: jnp.asarray(c[k]) for k in c if isinstance(c[k], np.ndarray)}
    if fused:
        t["rope_sin"], t["rope_cos"] = t["rope_sin"].double(), \
            t["rope_cos"].double()
        got = RT.fused_ragged_paged_attention(
            *(t[k] for k in ORDER), DUMP, rope_sin=t["rope_sin"],
            rope_cos=t["rope_cos"], qblock=c["qblock"])
        want = RJ.fused_ragged_paged_attention(
            *(j[k] for k in ORDER), DUMP, rope_sin=j["rope_sin"],
            rope_cos=j["rope_cos"], qblock=c["qblock"])[0]
    else:
        args = ("q", "k_pages", "v_pages", "block_tables", "kv_lens",
                "q_starts", "q_lens")
        ks, vs = (t[k].bfloat16() for k in ("k_scale", "v_scale"))
        got = RT.ragged_paged_attention(*(t[k] for k in args), k_scale=ks,
                                        v_scale=vs)
        want = RJ.ragged_paged_attention(
            *(j[k] for k in args),
            k_scale=jnp.asarray(c["k_scale"], jnp.bfloat16),
            v_scale=jnp.asarray(c["v_scale"], jnp.bfloat16))
    _close(got.float().numpy(), np.asarray(getattr(want, "_data", want)))


def test_int8_dequant_is_scale_times_value():
    """The plain read of an int8 pool is ``int8.float() * scale``: the
    same attention as over the pools dequantized first."""
    rng = np.random.RandomState(11)
    c = _int8_pools(_row_blocked(_case(rng, *CASES["mixed"])), rng)
    t = {k: torch.from_numpy(np.array(v)) for k, v in c.items()
         if isinstance(v, np.ndarray)}
    args = [t[k] for k in ("block_tables", "kv_lens", "q_starts", "q_lens")]
    q8 = RT.ragged_paged_attention_ref(t["q"], t["k_pages"], t["v_pages"],
                                       *args, k_scale=t["k_scale"],
                                       v_scale=t["v_scale"])
    kf = t["k_pages"].float() * t["k_scale"]
    vf = t["v_pages"].float() * t["v_scale"]
    assert torch.equal(q8, RT.ragged_paged_attention_ref(t["q"], kf, vf,
                                                         *args))


def test_supported_states_the_contract():
    c = _case(np.random.RandomState(12), *CASES["mixed"])
    t = {k: torch.from_numpy(np.array(v)) for k, v in c.items()
         if isinstance(v, np.ndarray)}
    fused = [t[k] for k in ORDER] + [DUMP]
    rope = dict(rope_sin=t["rope_sin"], rope_cos=t["rope_cos"], qblock=8)
    assert RT.fused_supported(*fused, **rope)
    assert not RT.fused_supported(*fused)            # packed q, no tables
    assert not RT.fused_supported(*fused[:-1], NUM_PAGES, **rope)
    sc = torch.ones(NUM_PAGES, HK, PAGE, 1)
    q8 = [a.to(torch.int8) for a in fused[3:5]]
    fused8 = fused[:3] + q8 + fused[5:]
    assert RT.fused_supported(*fused8, k_scale=sc, v_scale=sc, **rope)
    assert not RT.fused_supported(*fused8, k_scale=sc, **rope)
    assert not RT.fused_supported(*fused8, k_scale=sc[..., 0],
                                  v_scale=sc[..., 0], **rope)
    rb = _row_blocked(c)
    q4 = torch.from_numpy(rb["q"])
    rows = [t[k] for k in ("block_tables", "kv_lens", "q_starts", "q_lens")]
    assert RT.supported(q4, t["k_pages"], t["v_pages"], *rows)
    assert not RT.supported(q4[..., :8], t["k_pages"], t["v_pages"], *rows)
    assert RT.fused_supported(q4, *fused[1:])
    assert RT.fused_rope_geometry_ok(D) and not RT.fused_rope_geometry_ok(15)
    with pytest.raises(ValueError, match="both k_scale and v_scale"):
        RT.ragged_paged_attention(q4, t["k_pages"], t["v_pages"], *rows,
                                  k_scale=sc)


def test_pool_dtype_goes_with_the_sidecars():
    """Int8 pools without sidecars, or float pools with them, raise on the
    CPU too: the plain version would truncate the fresh rows into an
    int8 pool and attend over undequantized values."""
    c = _case(np.random.RandomState(13), *CASES["mixed"])
    t = {k: torch.from_numpy(np.array(v)) for k, v in c.items()
         if isinstance(v, np.ndarray)}
    fused = [t[k] for k in ORDER] + [DUMP]
    rope = dict(rope_sin=t["rope_sin"], rope_cos=t["rope_cos"], qblock=8)
    sc = torch.ones(NUM_PAGES, HK, PAGE, 1)
    q8 = [a.to(torch.int8) for a in fused[3:5]]
    fused8 = fused[:3] + q8 + fused[5:]
    rb = _row_blocked(c)
    q4 = torch.from_numpy(rb["q"])
    rows = [t[k] for k in ("block_tables", "kv_lens", "q_starts", "q_lens")]
    for args, kw in ((fused8, {}), (fused, dict(k_scale=sc, v_scale=sc)),
                     (fused[:3] + [q8[0], fused[4]] + fused[5:],
                      dict(k_scale=sc, v_scale=sc))):
        assert not RT.fused_supported(*args, **kw, **rope)
        before = [a.clone() for a in args[3:5]]
        with pytest.raises(ValueError, match="int8 pools with scales"):
            RT.fused_ragged_paged_attention(*args, **kw, **rope)
        assert all(torch.equal(a, b) for a, b in zip(args[3:5], before))
    with pytest.raises(ValueError, match="int8 pools with scales"):
        RT.ragged_paged_attention(q4, *q8, *rows)
    with pytest.raises(ValueError, match="int8 pools with scales"):
        RT.ragged_paged_attention(q4, t["k_pages"], t["v_pages"], *rows,
                                  k_scale=sc, v_scale=sc)
    assert RT.supported(q4, *q8, *rows, k_scale=sc, v_scale=sc)


# the reference's domain past the first slices' kernels: (page, head_dim,
# pool dtype); each point holds the plain versions against both reference
# formulations, for the rope-fused, fused and read-only calls
WIDE = {"page64_f32": (64, 16, "float32"), "f16_pools": (8, 16, "float16"),
        "d256_f32": (8, 256, "float32"), "int8_d72": (16, 72, "int8")}


def _ulp16(x):
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -14)))
    return 2.0 ** (e - 10)


@pytest.mark.parametrize("ref", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("kind", ["rope_fused", "fused", "read_only"])
@pytest.mark.parametrize("point", sorted(WIDE))
def test_widened_domain_matches_reference(monkeypatch, point, kind, ref):
    page, d, dtype = WIDE[point]
    monkeypatch.setitem(globals(), "PAGE", page)
    monkeypatch.setitem(globals(), "D", d)
    rng = np.random.RandomState(page + d)
    c = _case(rng, [(5, [6, 2]), (70, [1]), (130, [1])], 8, poison=True)
    if kind != "rope_fused":
        c = _row_blocked(c)
    q8 = dtype == "int8"
    if q8:
        c = _int8_pools(c, rng)
    elif dtype == "float16":
        c = {k: (v.astype(np.float16) if isinstance(v, np.ndarray)
                 and v.dtype == np.float32 and not k.startswith("rope")
                 else v) for k, v in c.items()}
    args = ("q", "k_pages", "v_pages", "block_tables", "kv_lens",
            "q_starts", "q_lens")
    if kind == "read_only":
        t = {k: torch.from_numpy(np.array(v)) for k, v in c.items()
             if isinstance(v, np.ndarray)}
        kw = dict(k_scale=t["k_scale"], v_scale=t["v_scale"]) if q8 else {}
        assert RT.supported(*(t[k] for k in args), **kw)
        got = [RT.ragged_paged_attention(*(t[k] for k in args),
                                         **kw).numpy()]
        fn = RJ.ragged_paged_attention if ref == "pallas_interpret" \
            else RJ.ragged_paged_attention_xla
        jkw = {k: jnp.asarray(c[k]) for k in ("k_scale", "v_scale")} \
            if q8 else {}
        r = fn(*(jnp.asarray(c[k]) for k in args), **jkw)
        want = [np.asarray(getattr(r, "_data", r))]
    else:
        rope = kind == "rope_fused"
        got = list(_run_torch(c, RT.fused_ragged_paged_attention,
                              rope=rope))
        fn = RJ.fused_ragged_paged_attention if ref == "pallas_interpret" \
            else RJ.fused_ragged_paged_attention_xla
        want = _run_ref(c, fn, rope=rope)
    assert got[0].shape == want[0].shape \
        == (len(c["kv_lens"]), c["qblock"] if kind != "rope_fused"
            else 8, HK * G, d)
    g0, w0 = (np.asarray(a, np.float32) for a in (got[0], want[0]))
    if dtype == "float16":
        # both sides round an f32 result to f16 once
        assert (np.abs(g0 - w0) <= _ulp16(w0) + 1e-5).all()
    else:
        _close(g0, w0)
    live = np.arange(NUM_PAGES) != DUMP
    keep = ~_written(c)[:, None, :, None] & live[:, None, None, None]
    if kind != "read_only":
        _unchanged(c, got, keep)
        # V slots (and int8 slots and scales without rope) bit for bit
        assert np.array_equal(got[2][live], want[2][live])
        if q8 and kind == "fused":
            for g, w in zip(got[1:], want[1:]):
                assert np.array_equal(g[live], w[live])
    assert not np.abs(g0[-1]).any()


def test_kernel_geometry_rule_and_messages():
    """The CUDA kernels' rule is the reference's shape rule; the launch
    converts what the reference converts (mixed float dtypes, integer
    rows, float sidecars, strided read-only operands), and what it still
    refuses is named: a dtype outside bf16/f16/f32, and pools or
    sidecars a fused call writes in place that it would have to copy or
    convert."""
    for page, d, dt, q8 in ((64, 256, torch.float32, False),
                            (16, 72, torch.bfloat16, True),
                            (8, 8, torch.float16, False),
                            (128, 128, torch.bfloat16, False)):
        RT.check_geometry(page, d, dt, q8)
    with pytest.raises(ValueError, match="page_size % 8"):
        RT.check_geometry(12, 128, torch.bfloat16)
    with pytest.raises(ValueError, match="up to 256"):
        RT.check_geometry(16, 264, torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16, float16 or float32"):
        RT.check_geometry(16, 128, torch.float64)
    q = torch.zeros(2, 1, 4, 256)
    pools = torch.zeros(6, 2, 64, 256)
    rows = [torch.zeros(2, 3, dtype=torch.int32)] + [
        torch.zeros(2, dtype=torch.int32)] * 3
    RT._check_kernel(q, pools, pools, None, None, rows)
    # converted by the launch: a q of another dtype, int64 rows, strided
    # read-only pools
    RT._check_kernel(q.bfloat16(), pools, pools, None, None,
                     [r.long() for r in rows])
    RT._check_kernel(q, pools[:, :, ::2], pools[:, :, ::2], None, None, rows)
    with pytest.raises(ValueError, match="any mix"):
        RT._check_kernel(q, pools.double(), pools.double(), None, None, rows)
    with pytest.raises(ValueError, match="integers"):
        RT._check_kernel(q, pools, pools, None, None,
                         [r.float() for r in rows])
    # written in place: never copied, never converted
    fresh = (torch.zeros(3, 2, 256),) * 2
    with pytest.raises(ValueError, match="in place"):
        RT._check_kernel(q, pools[:, :, ::2], pools[:, :, ::2], None, None,
                         rows, fresh, written=True)
    q8 = pools.to(torch.int8)
    sc = torch.ones(6, 2, 64, 1, dtype=torch.bfloat16)
    RT._check_kernel(q, q8, q8, sc, sc, rows)     # read only: converted
    with pytest.raises(ValueError, match="float32 sidecars"):
        RT._check_kernel(q, q8, q8, sc, sc, rows, fresh, written=True)


# (dtype, head_dim) of every point the card tests and ``chip_smoke.py``
# hold the kernels to: the card tests' RPA and RPA_WIDE, phase 3d's
# DOMAIN (page 64, f32, head_dim 256 and 72, f16 at page 48) and phase
# 3's Llama-3-8B shape
INSTANCE_POINTS = [
    ("bfloat16", 128, "tensor-core"), ("bfloat16", 64, "tensor-core"),
    ("float32", 128, "general"), ("bfloat16", 256, "tensor-core"),
    ("bfloat16", 72, "general"), ("float16", 64, "tensor-core"),
    ("float32", 256, "general"), ("float16", 8, "general"),
    ("float16", 128, "tensor-core"), ("float16", 16, "tensor-core"),
    ("bfloat16", 8, "general"), ("float16", 200, "general"),
]


@pytest.mark.parametrize("dtype,d,want", INSTANCE_POINTS)
def test_attention_instance_rule(dtype, d, want):
    """One rule on (model dtype, head_dim), float and int8 pools alike:
    bf16 and f16 at head_dim % 16 == 0 run the tensor-core instance,
    f32 and other head_dims the general one; a launch refuses any other
    pairing before it reaches the library."""
    dt = getattr(torch, dtype)
    assert RT.attention_instance(dt, d) == want
    assert RT._check_instance(want, dt, d) == RT._INSTANCES[want]
    other = {"tensor-core": "general", "general": "tensor-core"}[want]
    with pytest.raises(ValueError, match=f"the {other} attention instance"):
        RT._check_instance(other, dt, d)


def test_attention_instance_refuses_outside_the_domain():
    with pytest.raises(ValueError, match="bfloat16, float16 or float32"):
        RT.attention_instance(torch.float64, 128)
    with pytest.raises(ValueError, match="up to 256"):
        RT.attention_instance(torch.bfloat16, 272)
    with pytest.raises(ValueError, match="head_dim % 8"):
        RT.attention_instance(torch.float16, 20)


# rows: (kv_len, q_len, q_start) with group, qblock, table width, page
PLAN_ROWS = [
    (2901, 1, 2900, 4, 16, 200, 16),     # decode, 6 splits of 512
    (1024, 1, 1023, 4, 16, 200, 16),     # 4 splits of 256
    (1121, 16, 1105, 4, 16, 200, 16),    # a 16-token chunk, 64 rows
    (8192, 1, 8191, 4, 32, 512, 16),     # Llama-3-8B's full context
    (300, 32, 268, 4, 32, 20, 16),       # 128 rows: two tiles
    (5000, 1, 4999, 8, 1, 100, 64),      # group 8, 64-slot pages
    (9000, 1, 8999, 4, 1, 20, 16),       # past the table: capped at 320
    (40, 3, 37, 32, 4, 8, 8),            # group 32: two tiles
    (0, 1, 0, 4, 16, 10, 16),            # inactive
    (77, 0, 77, 4, 16, 10, 16),          # no query
    (3, 5, 7, 2, 8, 4, 8),               # queries past kv_len
]


@pytest.mark.parametrize("row", PLAN_ROWS)
def test_split_plan_covers_each_key_once(row):
    """Each tile's splits cut [0, n_keys) into consecutive runs, each key
    once, of TC_SPLIT_UNIT keys per 16 valid rows, twice that past
    TC_LONG_KEYS keys (the last run shorter);
    n_keys is the tile's last valid query's causal horizon clipped to
    kv_len and the table; the tiles hold every valid row once; and the
    partial buffers' slab holds every split of every valid row."""
    kv, ql, qs, group, qb, width, page = row
    plan = RT.split_plan(*row)
    rows = min(ql, qb) * group if kv > 0 and ql > 0 else 0
    assert sum(n for _, n, _ in plan) == rows
    assert [t for t, _, _ in plan] == list(range(len(plan)))
    for tile, n_valid, splits in plan:
        last_q = (tile * RT.TC_TILE_ROWS + n_valid - 1) // group
        n_keys = max(0, min(kv, qs + last_q + 1, width * page))
        split = RT.TC_SPLIT_UNIT * -(-n_valid // 16) \
            * (2 if n_keys > RT.TC_LONG_KEYS else 1)
        covered = [k for lo, hi in splits for k in range(lo, hi)]
        assert covered == list(range(n_keys))
        assert all(hi - lo == split for lo, hi in splits[:-1])
        assert all(0 < hi - lo <= split for lo, hi in splits)
        assert len(splits) * n_valid <= RT.tc_scratch_rows(width, page)


def test_split_plan_depends_on_the_row_alone():
    """A row's plan is a function of its own (kv_len, q_len, q_start)
    and the geometry: the same for the row alone and among any others,
    and the same whatever qblock once it holds the row's queries."""
    rng = np.random.RandomState(0)
    rows = [(int(k), int(n), int(k) - int(n))
            for k, n in zip(rng.randint(1, 4000, 40), rng.randint(1, 33, 40))]
    alone = [RT.split_plan(*r, 4, 32, 260, 16) for r in rows]
    for perm in (rng.permutation(len(rows)) for _ in range(3)):
        for i in perm:
            assert RT.split_plan(*rows[i], 4, 32, 260, 16) == alone[i]
    for r, want in zip(rows, alone):
        assert RT.split_plan(*r, 4, 64, 260, 16) == want


# the write launch's map: sequences of (prior context, [chunks]) with a
# chunk longer than a page, a row of 0 fresh tokens, decode rows and a
# long context; then padding tokens no row holds, an inactive row and a
# row with fresh tokens but kv_len 0
WRITE_SEQS = [(3, [20, 5]), (9, [1]), (0, [1]), (6, [0]), (300, [1]),
              (17, [70])]


def _write_case(page, pad, hk=2, d=8):
    rng = np.random.RandomState(page)
    n_pages = [max(1, -(-(p + sum(c)) // page)) for p, c in WRITE_SEQS]
    num_pages = sum(n_pages) + 3
    dump = num_pages - 1
    perm = rng.permutation(num_pages - 1)
    rows, used, t = [], 0, 0
    for (prior, chunks), npg in zip(WRITE_SEQS, n_pages):
        pages = perm[used:used + npg]
        used += npg
        start = prior
        for c in chunks:
            rows.append((pages, start + c, start, c, prior, t))
            start += c
        t += sum(chunks)
    rows.append(((), 0, 0, 0, 0, 0))                   # inactive
    rows.append((perm[-2:-1], 0, 0, 3, 0, 0))          # kv_len 0
    width = max(n_pages) + 1
    tables = np.full((len(rows), width), dump, np.int32)
    for i, row in enumerate(rows):
        tables[i, :len(row[0])] = row[0]
    meta = [torch.from_numpy(np.ascontiguousarray(m))
            for m in np.asarray([r[1:] for r in rows], np.int32).T]
    n_tok = t + pad
    return dict(n_tok=n_tok, tables=torch.from_numpy(tables), meta=meta,
                num_pages=num_pages, dump=dump, hk=hk, d=d, real=t)


@pytest.mark.parametrize("pad", [0, 5])
@pytest.mark.parametrize("page", [8, 16, 48, 256])
def test_write_slots_cover_each_fresh_token_once(page, pad):
    """The CUDA write launch's token -> (row, slot) map (``write_slots``,
    the rule the kernel applies to each packed token): every fresh token
    of an active row lands in exactly one slot, padding tokens and the
    rows that are inactive, have no fresh token or have kv_len 0 in
    none, no slot twice, never the dump page; and the slots are the
    plain write's (``fused_ragged_paged_attention_ref``, each token's
    K/V tagged with its index). The grid is a function of the packed
    tokens and kv heads only."""
    c = _write_case(page, pad)
    kv, qs, ql, ws, wf = c["meta"]
    plan = RT.write_slots(c["n_tok"], c["tables"], kv, qs, ql, ws, wf,
                          c["num_pages"], page)
    assert sorted(plan) == list(range(c["real"]))
    slots = [s for f in plan for s in plan[f]]
    assert all(len(plan[f]) == 1 for f in plan)
    assert len({(p, o) for _, p, o in slots}) == len(slots)
    assert all(p != c["dump"] for _, p, o in slots)
    assert all(0 <= o < page for _, p, o in slots)
    # the plain write, each token's K tagged f + 1 and V -(f + 1)
    hk, d, t = c["hk"], c["d"], c["n_tok"]
    tag = torch.arange(1, t + 1, dtype=torch.float32)[:, None, None]
    new_k = tag.expand(t, hk, d).contiguous()
    k_pages = torch.zeros(c["num_pages"], hk, page, d)
    v_pages = torch.zeros_like(k_pages)
    r = c["tables"].shape[0]
    q = torch.zeros(r, 1, hk * 2, d)
    RT.fused_ragged_paged_attention_ref(
        q, new_k, -new_k, k_pages, v_pages, c["tables"], kv, qs, ql, ws, wf,
        kv, c["dump"])
    written = {}
    for p, h, o in (k_pages[..., 0] != 0).nonzero().tolist():
        written.setdefault((p, o), set()).add(int(k_pages[p, h, o, 0]) - 1)
    assert bool((v_pages == -k_pages).all())
    assert all(len(f) == 1 for f in written.values())
    assert {key: min(f) for key, f in written.items()} == {
        (p, o): f for f in plan for _, p, o in plan[f]}
    blocks = RT.write_grid(t, hk)
    assert (blocks - 1) * RT.WRITE_WARPS < 2 * t * hk <= \
        blocks * RT.WRITE_WARPS
