#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA card. It
fails (non-zero exit, no result line) when there is no card or the
package is not beside it, and when any phase fails:

1. the card's name and power limit (``nvidia-smi``);
2. building every CUDA kernel of the serving path from ``csrc/``;
3. each kernel against its plain PyTorch version on the card, in bf16,
   at both shapes the serving path gives it (Llama-3-8B attention: 32 q
   heads, 8 kv heads, head_dim 128, page 16; a mixed dispatch at qblock
   32 and a decode-only one at qblock 1), with its time, the plain
   version's time, a PyTorch library call's time and the card's bound;
4. serving Llama-3-8B at full width and depth (random bf16 weights from
   a seeded generator on the card) through
   ``LlamaServingEngine.generate``: 8 prompts of 64-512 tokens, 32 new
   tokens each, with every launch of the kernels counted and the plain
   attention never called; every served token is checked against the
   model's own plain forward;
5. a JSON line of kernel results, then the final result line.
"""

import json
import os
import subprocess
import sys
import time

H, HK, D, PAGE, QB = 32, 8, 128, 16, 32     # Llama-3-8B serving shapes
HBM_BYTES_PER_S = 3.35e12                    # H100 SXM device memory
BF16_FLOPS = 989e12                          # H100 SXM dense bf16
OUT_VEC = 2 ** -10  # out slack beyond 1 ulp, x the head vector's max
NEW = 32            # new tokens per served request
EXACT_FLOOR = 0.75  # share of served tokens equal to the plain argmax
TIE_TOL = 0.5       # logit gap allowed to the plain forward's argmax
REPLACES = "paddle_tpu/ops/ragged_paged_attention.py:1060"


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if res.returncode != 0 or not res.stdout.strip():
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` over ``iters`` calls, CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_batch(dev, qb, ctx, chunks, inactive, seed=0):
    """One dispatch at serving shapes: 8 decode rows with contexts drawn
    from ``range(*ctx)``, then the ``chunks`` of one prompt as rows of
    the same dispatch, then (if ``inactive``) an inactive row; table
    tails past the live pages are poisoned with out-of-range ids.
    Returns (args, info)."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    dec = rng.randint(*ctx, size=8)
    seqs = [(int(n) - 1, [1]) for n in dec] + ([(0, chunks)] if chunks
                                                else [])
    n_pages = [-(-(p + sum(c)) // PAGE) for p, c in seqs]
    num_pages = sum(n_pages) + 17               # 16 untouched + dump
    dump = num_pages - 1
    perm = rng.permutation(num_pages - 1)
    width = max(n_pages) + 3
    rows, used, t = [], 0, 0
    for (prior, chs), npg in zip(seqs, n_pages):
        pages = perm[used:used + npg]
        used += npg
        start = prior
        for c in chs:
            rows.append((pages, start + c, start, c, prior, t,
                         prior + sum(chs)))
            start += c
        t += sum(chs)
    if inactive:
        rows.append(((), 0, 0, 0, 0, 0, 0))
    tables = np.empty((len(rows), width), np.int32)
    for i, row in enumerate(rows):
        tables[i] = rng.choice([-5, 10 ** 7, num_pages + 11], width)
        tables[i, :len(row[0])] = row[0]
    meta = np.asarray([r[1:] for r in rows], np.int32).T
    pos = np.concatenate([np.arange(s, s + n)
                          for _, _, s, n, *_ in rows if n > 0])
    g = torch.Generator(dev).manual_seed(seed)
    bf = dict(device=dev, dtype=torch.bfloat16, generator=g)
    from paddle_tpu_torch.ops.ragged_paged_attention import rope_tables
    sin, cos = rope_tables(torch.from_numpy(pos).to(dev), D, 500000.0)
    i32 = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
           for a in (tables, *meta)]
    args = dict(q=torch.randn(t, H, D, **bf),
                new_k=torch.randn(t, HK, D, **bf),
                new_v=torch.randn(t, HK, D, **bf),
                k_pages=torch.randn(num_pages, HK, PAGE, D, **bf),
                v_pages=torch.randn(num_pages, HK, PAGE, D, **bf),
                block_tables=i32[0], kv_lens=i32[1], q_starts=i32[2],
                q_lens=i32[3], w_starts=i32[4], w_flats=i32[5],
                w_ends=i32[6], dump_page=dump, rope_sin=sin, rope_cos=cos,
                qblock=qb)
    written = np.zeros((num_pages, PAGE), bool)
    pairs = 0                                   # unmasked (query, key)
    for pages, kv, qs, ql, *_ in rows:
        for p in range(qs, qs + ql):
            written[pages[p // PAGE], p % PAGE] = True
            pairs += p + 1
    info = dict(rows=len(rows), tokens=t, num_pages=num_pages, dump=dump,
                written=torch.from_numpy(written).to(dev), pairs=pairs,
                prior_tokens=sum(p for p, _ in seqs))
    return args, info


def bound(args, info):
    """Least time the card could take: every input byte read once and
    every output byte written once over the memory rate, or the
    attention's operations over the bf16 rate; the larger wins."""
    t = info["tokens"]
    el = 2                                      # bf16 bytes
    nbytes = (2 * info["prior_tokens"] * HK * D * el     # live K/V read
              + t * H * D * el + 2 * t * HK * D * el     # q, new K/V
              + 2 * t * D * 4                            # sin/cos
              + sum(args[k].numel() * 4 for k in (
                  "block_tables", "kv_lens", "q_starts", "q_lens",
                  "w_starts", "w_flats", "w_ends"))
              + info["rows"] * args["qblock"] * H * D * el   # out
              + 2 * t * HK * D * el)                     # fresh K/V
    ops = 4 * D * H * info["pairs"]              # QK^T and PV
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def ulp_bf16(x):
    """The bf16 spacing at each element of ``x`` (0 at 0)."""
    import torch
    x = x.float()
    _, e = torch.frexp(x)
    ulp = torch.ldexp(torch.ones_like(x), e - 8)
    return torch.where(x == 0, torch.zeros_like(ulp), ulp)


def check_kernel(dev, label, qb, ctx, chunks, inactive):
    """Phase 3: the rope-fused ragged paged attention kernel against
    its plain version on one dispatch; returns its numbers."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    args, info = attention_batch(dev, qb, ctx, chunks, inactive)
    k0, v0 = args["k_pages"], args["v_pages"]
    run = {}
    for name, fn in (("kernel", rpa.fused_ragged_paged_attention),
                     ("plain", rpa.fused_ragged_paged_attention_ref)):
        a = dict(args, k_pages=k0.clone(), v_pages=v0.clone())
        out = fn(**a)
        torch.cuda.synchronize()
        run[name] = (out, a)
    (out_k, a_k), (out_r, a_r) = run["kernel"], run["plain"]
    if not torch.isfinite(out_k.float()).all():
        fail(f"{label}: kernel output has non-finite values")
    # each output element within 1 bf16 ulp of the plain version's plus
    # OUT_VEC of its head vector's largest value (f32 summation order);
    # zeros (padding, inactive rows) must be exact
    ref, got = out_r.float(), out_k.float()
    diff = (got - ref).abs()
    vec_max = ref.abs().amax(dim=-1, keepdim=True)
    over = diff - (ulp_bf16(ref) + OUT_VEC * vec_max)
    if bool((over > 0).any()):
        r_i, q_i, h_i, d_i = [int(x) for x in (over > 0).nonzero()[0]]
        fail(f"{label}: kernel out differs at row {r_i} query {q_i} head "
             f"{h_i} col {d_i}: {float(got[r_i, q_i, h_i, d_i])} vs "
             f"{float(ref[r_i, q_i, h_i, d_i])}")
    err = float(diff.max())
    rel = float((diff / vec_max.clamp_min(1e-30)).max())
    live = torch.arange(info["num_pages"], device=dev) != info["dump"]
    wr = info["written"][:, None, :, None].expand_as(k0) \
        & live[:, None, None, None]
    keep = ~info["written"][:, None, :, None].expand_as(k0) \
        & live[:, None, None, None]
    kk, kr = a_k["k_pages"][wr].float(), a_r["k_pages"][wr].float()
    if not bool(((kk - kr).abs() <= ulp_bf16(kr)).all()):
        fail(f"{label}: written K slots differ from the plain version by "
             "> 1 ulp")
    if not torch.equal(a_k["v_pages"][wr], a_r["v_pages"][wr]):
        fail(f"{label}: written V slots differ from the plain version")
    for pool, orig in ((a_k["k_pages"], k0), (a_k["v_pages"], v0)):
        if not torch.equal(pool[keep], orig[keep]):
            fail(f"{label}: the kernel changed slots no row writes")
    k_bits = int(torch.equal(kk, kr))
    # timing: the kernel rewrites the same slots each call (idempotent)
    ms = time_ms(lambda: rpa.fused_ragged_paged_attention(**a_k))
    plain_ms = time_ms(lambda: rpa.fused_ragged_paged_attention_ref(**a_r),
                       iters=5, warmup=1)
    # library yardstick: SDPA over the gathered pages with the same
    # mask (attention only; the port never calls it)
    tables = args["block_tables"].long().clamp(0, info["num_pages"] - 1)
    r = tables.shape[0]
    group = H // HK

    def gathered(pool):
        x = pool[tables].transpose(2, 3).reshape(r, -1, HK, D)
        return x.repeat_interleave(group, dim=2).transpose(1, 2)
    kg, vg = gathered(a_k["k_pages"]), gathered(a_k["v_pages"])
    qr = torch.zeros(r, qb, H, D, device=dev, dtype=torch.bfloat16)
    meta = [args[k].tolist() for k in ("q_starts", "q_lens", "w_starts",
                                       "w_flats")]
    for i, (qs, ql, ws, wf) in enumerate(zip(*meta)):
        qr[i, :ql] = args["q"][wf + qs - ws:wf + qs - ws + ql]
    qr = qr.transpose(1, 2)
    kpos = torch.arange(kg.shape[2], device=dev)
    qpos = args["q_starts"].long()[:, None] + torch.arange(qb, device=dev)
    mask = (kpos[None, None] <= qpos[:, :, None]) \
        & (kpos[None, None] < args["kv_lens"].long()[:, None, None]) \
        & (torch.arange(qb, device=dev)[None, :, None]
           < args["q_lens"].long()[:, None, None])
    mask = mask[:, None]
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qr, kg, vg, attn_mask=mask))
    bound_ms, bound_by = bound(args, info)
    print(f"kernel check ({label}): qblock={qb} rows={info['rows']} "
          f"tokens={info['tokens']} pages={info['num_pages']} "
          f"out_err={err:.3e} (max err / head-vector max {rel:.3e}; tol "
          f"1 ulp + {OUT_VEC} x head-vector max) "
          f"written_K_bitwise={bool(k_bits)} ms={ms:.4f} "
          f"plain_ms={plain_ms:.3f} library_ms={library_ms:.4f} "
          f"bound_ms={bound_ms:.5f} ({bound_by})", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def check_kernels(dev):
    """Phase 3 at both shapes the serving path launches the kernel with:
    a mixed dispatch (qblock = chunk_block) and a decode-only one
    (qblock 1, contexts of the served requests). Returns the kernel's
    JSON entry (without ``launches``) with the mixed dispatch's times."""
    mixed = check_kernel(dev, "mixed", QB, (100, 2001), [QB, QB], True)
    decode = check_kernel(dev, "decode", 1, (64, 545), [], False)
    return dict(name="fused_ragged_paged_attention_rope", route="cuda",
                source="paddle_tpu_torch/csrc/ragged_paged_attention.cu",
                replaces=REPLACES, **dict(mixed, max_abs_err=max(
                    mixed["max_abs_err"], decode["max_abs_err"])))


def serving_workload(dev):
    """Llama-3-8B at full width and depth (random bf16 weights from a
    seeded generator on the card) behind ``LlamaServingEngine(max_batch
    =8, page_size=16)``, warmed up, and 8 prompts of 64-512 tokens.
    Returns (cfg, model, engine, prompts)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.inference import LlamaServingEngine
    from paddle_tpu_torch.models import LlamaForCausalLM, llama3_8b_config
    cfg = llama3_8b_config()
    t0 = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(0)
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                             generator=gen).eval()
    torch.cuda.synchronize()
    print(f"model: llama3_8b layers={cfg.num_hidden_layers} params="
          f"{model.num_params()} init_s={time.perf_counter() - t0:.1f}",
          flush=True)
    engine = LlamaServingEngine(model, max_batch=8, page_size=16)
    rng = np.random.RandomState(0)
    lens = np.linspace(64, 512, 8).astype(int)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist() for n in lens]
    engine.generate([prompts[0][:16]], max_new_tokens=2)   # warm-up
    return cfg, model, engine, prompts


def serve(dev):
    """Phase 4: serve Llama-3-8B through the engine's entry point;
    returns the number of kernel launches the run made."""
    import torch
    from paddle_tpu_torch.inference import Request
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    cfg, model, engine, prompts = serving_workload(dev)
    finite = []
    hook = model.lm_head.register_forward_hook(
        lambda mod, inp, out: finite.append(torch.isfinite(out).all()))
    plain_calls = []
    plain = rpa.fused_ragged_paged_attention_ref

    def counted_plain(*a, **k):
        plain_calls.append(1)
        return plain(*a, **k)
    rpa.fused_ragged_paged_attention_ref = counted_plain
    reqs = [Request(p, max_new_tokens=NEW) for p in prompts]
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    rpa.launches = 0
    d0 = engine._dispatch_count
    t0 = time.perf_counter()
    outs = engine.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = rpa.launches
    dispatches = engine._dispatch_count - d0
    rpa.fused_ragged_paged_attention_ref = plain
    hook.remove()
    if plain_calls:
        fail(f"the plain attention ran {len(plain_calls)} times on the "
             "card")
    want = 2 * cfg.num_hidden_layers * dispatches
    if launches != want or launches == 0:
        fail(f"kernel launches {launches} != 2 x layers x dispatches "
             f"= {want}")
    if not all(bool(f) for f in finite):
        fail("non-finite logits in the serving run")
    for o in outs:
        if len(o) != NEW or not all(0 <= t < cfg.vocab_size for t in o):
            fail(f"bad output {o}")
    # every served token against the model's own plain forward (no
    # cache, plain attention) fed the same tokens: most must be its
    # argmax, the rest bf16 near-ties of it
    gaps = []
    for p, o in zip(prompts, outs):
        ids = torch.tensor([p + o[:-1]], device=dev)
        with torch.no_grad():
            lg = model(ids)[0, len(p) - 1:].float()
        picked = lg.gather(1, torch.tensor(o, device=dev)[:, None])[:, 0]
        gaps.append(lg.max(dim=1).values - picked)
    gaps = torch.cat(gaps)
    exact, worst = int((gaps == 0).sum()), float(gaps.max())
    n_tok = len(prompts) * NEW
    ttft = sorted(r.ttft for r in reqs)
    print(f"serve: requests={len(prompts)} prompt_tokens="
          f"{sum(map(len, prompts))} new_tokens={n_tok} dispatches="
          f"{dispatches} launches={launches} wall_s={wall:.3f} "
          f"tokens_per_s={n_tok / wall:.1f} ttft_ms_p50="
          f"{1e3 * ttft[len(ttft) // 2]:.1f} ttft_ms_max={1e3 * ttft[-1]:.1f}"
          f" peak_mem_gb={torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"
          f" plain_forward_exact={exact}/{n_tok} worst_gap={worst:.4f} "
          f"gap_p90={float(gaps.quantile(0.9)):.4f}", flush=True)
    if exact < EXACT_FLOOR * n_tok:
        fail(f"only {exact}/{n_tok} served tokens are the plain forward's "
             f"argmax (floor {EXACT_FLOOR})")
    if worst > TIE_TOL:
        fail(f"served token {worst:.3f} below the plain forward's argmax")
    return launches


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from paddle_tpu_torch.ops import _build
    except ImportError as e:
        fail(f"paddle_tpu_torch is not beside chip_smoke.py ({e})")
    dev = torch.device("cuda")
    print(card_line(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build_s={time.perf_counter() - t0:.1f}", flush=True)
    entry = check_kernels(dev)
    torch.cuda.empty_cache()
    entry["launches"] = serve(dev)
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
