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
   (phases 3 and 3d also print each kernel's device time from the
   profiler, which leaves out the host's time between launches, and for
   each fused call its write launch's device time alone beside the
   write's bound);
3d. the rest of the ragged paged attention family at phase 3's shapes
   and dispatches: the rope-fused call over int8 pools (#13), the
   post-rope fused call over bf16 and int8 pools (#11a, #11b) and the
   read-only call over pools written before (#10, #9); written int8
   slots and their scales bit for bit ``quantize_kv_int8`` in PyTorch on
   the card, written bf16 slots as phase 3, untouched slots and the dump
   page unchanged, outputs within phase 3's bound; each with the same
   four times (the library call: SDPA over the gathered K/V, dequantized
   to bf16 for int8); then every call form of the family at the
   reference's domain past phase 3's geometry (``DOMAIN``: pages of 64
   and 48 slots, f32 and f16 models, head_dim 256 and 72, int8 pools
   too), untimed, within phase 3's bound;
3f. #12 and #13 on 8 decode rows at Llama-3-8B's full context (contexts
   of 1-8192 tokens) at qblock 1 and 32, timed as phase 3 (where the
   tensor-core instance's split over the sequence shows); phases 3, 3d
   and 3f print the instance each launch ran (``attention_instance``);
3e. the decode paged attention kernel (#4, the ``PagedKVCache`` path)
   against its plain version: at phase 3's decode-only shape (8 rows,
   contexts 64-544, 32/8 heads, head_dim 128, page 16) over bf16 and f32
   pools, the bf16 pools also through #10's decode-only launch, and at
   Llama-3-8B's full context (32 bf16 rows over 1-8192 tokens, an
   inactive row among them); table tails poisoned; outputs within phase
   3's bound; the same four times (the library call: SDPA over the
   gathered K/V, kv heads repeated, with a length mask); then the
   reference's other operand forms (int64 tables and lens, bf16 q over
   f32 pools, f32 q over bf16 pools, raw int8 pools, a strided q) and a
   group of 512 query heads (H 1024, Hk 2, head_dim 256, f32), each in
   exactly one launch and no plain call, within the same bound, with the
   instance each ran;
3b. the training kernels against their plain versions on the card:
   flash attention forward, dQ and dK/dV at Llama-3-8B training shapes
   (batch 2 x seq 2048, 32 q / 8 kv heads, head_dim 128, bf16, causal;
   also a non-causal and a shorter-query causal case), and the fused
   linear cross-entropy forward at N = D = 4096, V = 128256, f32, 5% of
   rows ignored (the tensor-core instance, 3xTF32); each with its time
   (CUDA events and the profiler's device time), the plain version's, a
   PyTorch library call's and the card's bound (the loss: both, f32 on
   the CUDA cores and 3xTF32 on the tensor cores), and the instance each
   kernel ran (the wgmma instances at the training batch, with dQ's,
   dK/dV's and the loss's registers); then the loss and its gradients
   through the public function at bf16 hidden and weight (the same
   shape, timed too) and at D = 4100, f16 hidden and f32 weight (the
   general instance), against the plain path;
   then the flash kernels' general
   instance at ``FLASH_DOMAIN``'s points (f32 head_dim 128, bf16 96 and
   256, f16 64); the registers and spills of every flash instance, of the
   ragged attention's tensor-core instance and of the dequant matmul's
   cluster instance (``ptxas -v``) are printed after the build;
4. serving Llama-3-8B at full width and depth (random bf16 weights from
   a seeded generator on the card) through
   ``LlamaServingEngine.generate``: 8 prompts of 64-512 tokens, 32 new
   tokens each, with every launch of the kernels counted and the plain
   attention never called; every served token is checked against the
   model's own plain forward;
5. training at Llama-3-8B width cut to 8 layers (random f32 weights from
   a seeded generator on the card) through
   ``examples.llama_pretrain.train``: bf16 ``auto_cast``, AdamW, batch 2
   x seq 2048, 10 steps on one fixed seeded batch, every kernel launch
   counted (one of each flash kernel per layer per step, one loss kernel
   per step) and no plain version called, finite and falling losses;
   then one step of a 2-layer model with the kernels against the same
   step with the plain versions (loss and gradients), under bf16
   ``auto_cast`` and again in f32 (the flash kernels' general instance);
3c. (run after 3b) the mixture-of-experts and int8 kernels against their
   plain versions at Mixtral-8x7B serving shapes (hidden 4096, expert
   FFN 14336, 8 experts, top 2, block 128) for the two token counts of
   the serving run (8, a decode-only dispatch; 64, a full mixed one):
   the dequant matmul (q/o N = 4096, k/v N = 1024), the int8 and the
   bf16 grouped GEMMs (gate/up and down shapes, routed by
   ``top_k_routing``, plus an empty expert and group sizes past the
   stride), the grouped GEMM's dx through its backward, each timed by
   CUDA events and by the profiler's device time beside the library
   call's two times; the dequant matmul's rows 0, 5 and 37 alone and
   among 7 and 63 others, bitwise equal, at both N; then tokens through a
   Mixtral-width ``LlamaMoEMLP`` alone and packed among 7 and among 63
   others, bitwise equal, float and int8; the instance each grouped GEMM
   launch ran (both kernels' cluster instances at 16-bit x, their
   registers and spills printed); then the three kernels at
   ``GEMM_DOMAIN``'s points of the reference's domain (f16 x, blocks of
   8, 24 and 40, N 24, K and N off multiples of 8), each on the instance
   ``gemm_instance`` names (the general one but for the f16 points of
   the grouped GEMMs, which their cluster instances take), two f16
   points and a B = 24 point timed as the Mixtral shapes are (with bound
   and library time);
6. serving Mixtral-8x7B at full width and depth with int8 weights (built
   layer by layer from a seeded generator on the card, each layer
   quantized as it is made: 93 GB of bf16 never exist at once) through
   ``LlamaServingEngine(weight_dtype="int8")``: phase 4's prompts, every
   launch counted (per dispatch: the attention kernel's two launches,
   four dequant matmuls and three int8 grouped GEMMs per layer), no
   plain version called, every served token checked against the model's
   own forward through the plain versions of all kernels;
7. the same for the bf16 MoE FFN at 4 layers (32 need two cards) with
   ``weight_dtype=None``: three float grouped GEMMs per layer;
8. (run after 4) Llama-3-8B at full width and depth with int8 KV pages,
   ``LlamaServingEngine(kv_dtype="int8")``, phase 4's prompts: every
   launch of #13 counted (2 a layer a dispatch), no plain version
   called, the KV pool's bytes beside phase 4's, every served token
   checked against the model's own plain forward with K and V through
   ``quantize_kv_int8`` and back (phase 4's floors), and the share of
   tokens equal to phase 4's printed;
9. (run after 8) the engine's three attention paths at Llama-3-8B width
   cut to 4 layers, both KV dtypes, phase 4's prompts: rope-fused (#12 /
   #13), ``fused_rope=False`` (#11a / #11b) and ``fused_kv=False`` (the
   PyTorch scatter, then #10 / #9): identical greedy tokens; pools,
   sidecars and attention outputs bitwise equal after the first (mixed)
   dispatch, pools after the whole run; launches counted per path (2 a
   layer a dispatch fused, 1 two-op), no plain version called;
9b. (run after 9) the engine at Llama-3-8B width cut to 4 layers,
   phase 4's prompts, at 64-slot pages (bf16) and as an f32 model, and
   cut to 2 layers as an f16 model with ``weight_dtype="int8"`` (the
   dequant matmul on f16 x): every #12 and dequant launch counted, no
   plain version called, tokens held against the plain forward (with the
   plain dequant matmul) at phase 4's floors;
10. (run after 9b) ``PagedKVCache`` at Llama-3-8B attention width on the
   card (12288 pages of 16 tokens, bf16): 32 sequences admitted with
   seeded prompts of 1-8160 tokens and their K/V written, 32 decode
   steps of ``extend`` + ``write`` + ``attend``, then half of them
   released and 16 new ones admitted on the recycled pages, 8 more
   steps; one #4 launch per ``attend`` and no plain version called; the
   first and last step of each stretch held against the plain version on
   the same pools within phase 3's bound; every launch on the
   tensor-core instance; mean ``attend`` time (host clock,
   synchronised), device time, the host's share, pool bytes and peak
   memory;
3g. (run after 3c) the sampler's Gumbel pass (``gumbel_argmax`` and
   ``gumbel_noise``) against its plain version at 8 and 64 rows of
   Llama-3's (128256) and Mixtral's (32000) vocabularies, greedy, top-k,
   top-p and constrained rows mixed, their scores and thresholds from the
   sampler's own plain steps: bits and uniforms bit for bit, ``g`` within
   ``GUMBEL_REL`` of max(|g|, 1), tokens equal but where the plain
   version's top two perturbed scores lie within that tolerance (each such
   row printed with its margin); the kernel's time (CUDA events and the
   profiler's device time), the plain version's, the sampler's sort's and
   the bound (the larger of the scores' bytes and ``GUMBEL_INT_OPS``
   32-bit integer operations an element at the integer pipe's rate);
11. (run after 4) phase 4's model and prompts with sampled rows: 2
   greedy, 2 at temperature 0.8 / top_p 0.9, 2 at temperature 1.0 /
   top_k 50, 1 with a ``logit_bias`` forcing a token and 1 with a
   constraint hook; the greedy rows bitwise phase 4's tokens, a second
   run with the same seeds identical, the forced and constrained rows
   obeying their rules, the sampled tokens replayed through the model's
   plain forward and the plain sampler at the same (seed, position) at
   phase 4's share floor (the margins of the rows that differ printed),
   exactly one ``gumbel_argmax`` launch and one sort per dispatch that
   holds a sampled row, no plain version called; tokens/s beside phase
   4's (phase 4 itself, all greedy, sorts nothing);
12. (run after 11) ``LlamaForCausalLM.generate`` at Llama-3-8B's full
   width and depth over its static KV cache: 4 prompts of 128 tokens, 32
   new tokens, greedy (tokens held against the plain forward at phase 4's
   floors, and their share equal to the engine's greedy tokens printed)
   and ``do_sample`` (top_k 50, top_p 0.9, fixed seed: one
   ``gumbel_argmax`` launch a step, no plain version called), each with
   its time per step;

then a JSON line of kernel results and the final result line.
"""

import contextlib
import dataclasses
import itertools
import json
import math
import os
import subprocess
import sys
import time

H, HK, D, PAGE, QB = 32, 8, 128, 16, 32     # Llama-3-8B serving shapes
HBM_BYTES_PER_S = 3.35e12                    # H100 SXM device memory
BF16_FLOPS = 989e12                          # H100 SXM dense bf16
OUT_VEC = 2 ** -10  # out slack beyond 1 ulp, x the head vector's max
# gradient rows can cancel to f32 rounding noise (the first causal query:
# one key, P = 1, dP - delta = 0); that noise scales with the terms, so a
# gradient's head-vector max is taken at least GRAD_FLOOR x the tensor max
GRAD_FLOOR = 2 ** -6
NEW = 32            # new tokens per served request
EXACT_FLOOR = 0.75  # share of served tokens equal to the plain argmax
TIE_TOL = 0.5       # logit gap allowed to the plain forward's argmax
RPA_SOURCE = "paddle_tpu_torch/csrc/ragged_paged_attention.cu"
# the ragged paged attention family: launch-count key -> (JSON name, line
# of the TPU kernel's pallas_call in paddle_tpu/ops/ragged_paged_attention
# .py, rope inside the call, int8 pools, read-only)
VARIANTS = {
    "fused_rope": ("fused_ragged_paged_attention_rope", 1060, True, False,
                   False),                                        # 12
    "fused_rope_q8": ("fused_ragged_paged_attention_rope_q8", 1133, True,
                      True, False),                               # 13
    "fused": ("fused_ragged_paged_attention", 921, False, False, False),
    "fused_q8": ("fused_ragged_paged_attention_q8", 990, False, True,
                 False),                                          # 11b
    "ragged": ("ragged_paged_attention", 368, False, False, True),  # 10
    "ragged_q8": ("ragged_paged_attention_q8", 328, False, True, True),
}
F32_FLOPS = 67e12   # H100 SXM f32 outside the tensor cores
TF32_FLOPS = 494.7e12   # H100 SXM dense TF32 on the tensor cores
TRAIN_B, TRAIN_S = 2, 2048               # Llama-3-8B training batch
TRAIN_LAYERS, TRAIN_STEPS = 8, 10        # depth cut to fit one card
CE_N, CE_D, CE_V = 4096, 4096, 128256    # the loss at those shapes
CE_IGNORED = 0.05   # share of loss rows at ignore_index
CE_GENERAL = (512, 4100, 32000)   # N, D, V of the general instance's point
LSE_ABS = 1e-3      # flash lse tolerance
CE_REL = 1e-4       # loss kernel lse/pick, relative to max(|x|, 1)
LOSS_REL = 1e-5     # loss through the kernel vs through the plain version
GRAD_REL = 1e-4     # CE grads vs the plain path, x the grad's max
STEP_LOSS_REL = 1e-2   # whole-model step, kernels vs plain versions
GRAD_COS, GRAD_NORM = 0.999, 0.01
FA_SOURCE = "paddle_tpu_torch/csrc/flash_attention.cu"
FA_REPLACES = {"forward": "paddle_tpu/ops/flash_attention.py:155",
               "dq": "paddle_tpu/ops/flash_attention.py:279",
               "dkv": "paddle_tpu/ops/flash_attention.py:299"}
FA_NAMES = {"forward": "flash_attention_forward",
            "dq": "flash_attention_backward_dq",
            "dkv": "flash_attention_backward_dkv"}
# Mixtral-8x7B-v0.1 (Jiang et al., arXiv 2401.04088): the published
# config of mistralai/Mixtral-8x7B-v0.1, its eleven numbers as they are
MIXTRAL = dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
               num_hidden_layers=32, num_attention_heads=32,
               num_key_value_heads=8, max_position_embeddings=32768,
               rms_norm_eps=1e-5, rope_theta=1e6, moe_num_experts=8,
               moe_top_k=2)
MOE_TOKENS = (8, 64)     # decode-only and full mixed dispatch, max_batch 8
WEIGHT_BLOCK = 128       # the int8 format's default block
FLOAT_MOE_LAYERS = 4     # bf16 Mixtral: 4 layers fit one card, 32 do not
LADDER_LAYERS = 4        # phase 9: Llama-3-8B width cut to 4 layers
# phase 3d: #13, #11a, #11b, #10, #9 (keys of VARIANTS)
FAMILY = ("fused_rope_q8", "fused", "fused_q8", "ragged", "ragged_q8")
# layer 0: an engine route may sit this far below the plain router's
# k-th logit (random router logits have std ~1.3; rounding moves them
# by ~0.01)
ROUTE_TOL = 0.1
GG_SOURCE = "paddle_tpu_torch/csrc/grouped_gemm.cu"
PA_SOURCE = "paddle_tpu_torch/csrc/paged_attention.cu"
PA_REPLACES = "paddle_tpu/ops/paged_attention.py:153"
FULL_CTX = 8192          # Llama-3-8B's context (max_position_embeddings)
# phase 10: one PagedKVCache on the card (12288 pages of 16 tokens, bf16:
# 768 MiB of pools), 32 sequences, then half of them replaced
CACHE_PAGES, CACHE_ROWS, CACHE_PROMPT = 12288, 32, 8160
CACHE_STEPS, CACHE_REFILL_STEPS = 32, 8
# the sampler (phases 3g, 11, 12): no Pallas kernel; the line of the
# reference's Gumbel-max argmax it replaces
SM_SOURCE = "paddle_tpu_torch/csrc/sampling.cu"
SM_REPLACES = "paddle_tpu/inference/sampling.py:234"
SAMPLER_VOCABS = {"llama3": 128256, "mixtral": 32000}
SAMPLER_ROWS = (8, 64)
# 32-bit integer operations an element: 20 threefry rounds of add, rotate
# and xor, 5 key injections, the 64-bit counter and the uniform's shift/or
GUMBEL_INT_OPS = 85
# the integer pipe: 64 lanes an SM against the 128 f32 lanes whose FMAs
# (2 operations) make F32_FLOPS, so a quarter of that rate
INT32_OPS = F32_FLOPS / 4
SAMPLED_ROWS = (None, None, dict(temperature=0.8, top_p=0.9),
                dict(temperature=0.8, top_p=0.9),
                dict(temperature=1.0, top_k=50), dict(temperature=1.0,
                                                      top_k=50),
                "forced", "constrained")
FORCED_TOKEN = 1234
ALLOWED = (11, 22, 33, 44, 55, 66, 77, 88)
GEN_PROMPTS, GEN_LEN, GEN_NEW = 4, 128, 32


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


def device_ms_by_kernel(fn, iters=20):
    """Mean device time per call of each kernel (and copy) ``fn``
    launches, ``{name: ms}``, from ``torch.profiler``: unlike
    :func:`time_ms` it leaves out the host's time between launches,
    which is longer than the kernels' at small shapes."""
    import collections
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and not getattr(e, "is_user_annotation", False):
            by_name[e.name] += (e.time_range.end - e.time_range.start) \
                / iters / 1e3
    return by_name


def device_ms(fn, iters=20):
    """Mean device time of the kernels ``fn`` launches, per call
    (:func:`device_ms_by_kernel`, summed)."""
    return sum(device_ms_by_kernel(fn, iters).values())


def attention_batch(dev, qb, ctx, chunks, inactive, seed=0, page=PAGE,
                    d=D, dtype="bfloat16"):
    """One dispatch at serving shapes (pages of ``page`` slots, head_dim
    ``d``, model dtype ``dtype``): 8 decode rows with contexts drawn
    from ``range(*ctx)``, then the ``chunks`` of one prompt as rows of
    the same dispatch, then (if ``inactive``) an inactive row; table
    tails past the live pages are poisoned with out-of-range ids.
    Returns (args, info)."""
    import numpy as np
    import torch
    PAGE, D = page, d   # phase 3's names, at this geometry
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
    bf = dict(device=dev, dtype=getattr(torch, dtype), generator=g)
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


def bound(args, info, variant="fused_rope"):
    """Least time the card could take for one call of ``variant``: every
    input byte read once and every output byte written once over the
    memory rate, or the attention's operations over the bf16 rate; the
    larger wins. Pools are bf16, or int8 with one f32 scale per (token,
    kv head); the read-only calls read the whole context from the pools,
    the others read the fresh K/V from ``new_k``/``new_v`` and write
    them (quantized where the pools are int8)."""
    _, _, rope, q8, read_only = VARIANTS[variant]
    t = info["tokens"]
    el = 2                                      # bf16 bytes
    slot = HK * (D * (1 if q8 else el) + (4 if q8 else 0))   # a pool token
    kv_read = info["prior_tokens"] + (t if read_only else 0)
    # q: the valid query rows only, whatever its layout (a row-blocked
    # q's padding is never read)
    q_rows = int(args["q_lens"].sum())
    nbytes = (2 * kv_read * slot                         # live K/V read
              + q_rows * H * D * el                      # q
              + sum(args[k].numel() * 4 for k in (
                  "block_tables", "kv_lens", "q_starts", "q_lens",
                  "w_starts", "w_flats", "w_ends") if k in args)
              + info["rows"] * info["qblock"] * H * D * el)  # out
    if not read_only:
        nbytes += 2 * t * HK * D * el + 2 * t * slot     # fresh in, written
    if rope:
        nbytes += 2 * t * D * 4                          # sin/cos
    ops = 4 * D * H * info["pairs"]              # QK^T and PV
    return roofline(nbytes, ops, BF16_FLOPS)


def write_bound(args, info, variant):
    """Least time the card could take for the write launch of one call
    of the fused ``variant``: the fresh K/V read once, their slots (and
    int8 scales) written once, the rows' metadata and, with rope, K's
    sin/cos rows read once, over the memory rate."""
    _, _, rope, q8, _ = VARIANTS[variant]
    t, d = info["tokens"], args["new_k"].shape[-1]
    el = args["new_k"].element_size()
    slot = HK * (d * (1 if q8 else el) + (4 if q8 else 0))
    nbytes = 2 * t * HK * d * el + 2 * t * slot \
        + 5 * info["rows"] * 4 + (2 * t * d * 4 if rope else 0)
    return roofline(nbytes, 0, BF16_FLOPS)


def ulp_bf16(x):
    """The bf16 spacing at each element of ``x`` (0 at 0)."""
    import torch
    x = x.float()
    _, e = torch.frexp(x)
    ulp = torch.ldexp(torch.ones_like(x), e - 8)
    return torch.where(x == 0, torch.zeros_like(ulp), ulp)


def check_close(label, got, ref, floor=0.0):
    """Each element of ``got`` within 1 bf16 ulp of ``ref`` plus OUT_VEC
    of its head vector's (last axis) largest value, that largest value
    taken at least ``floor`` x the tensor's largest; returns the largest
    absolute difference."""
    import torch
    ref, got = ref.float(), got.float()
    if not torch.isfinite(got).all():
        fail(f"{label}: non-finite values")
    diff = (got - ref).abs()
    vec_max = ref.abs().amax(dim=-1, keepdim=True).clamp_min(
        floor * float(ref.abs().max()))
    over = diff - (ulp_bf16(ref) + OUT_VEC * vec_max)
    if bool((over > 0).any()):
        idx = tuple(int(x) for x in (over > 0).nonzero()[0])
        fail(f"{label}: differs at {idx}: {float(got[idx])} vs "
             f"{float(ref[idx])}")
    return float(diff.max())


def variant_args(args, variant, q8_pools):
    """The keyword arguments of one call of ``variant`` on phase 3's
    dispatch ``args`` (packed pre-rope q and fresh K/V, bf16 pools):
    fresh copies of the pools, or of their int8 twins ``q8_pools`` and
    sidecars; q gathered into ``[R, qblock]`` row blocks where the call
    takes it post-rope; the write operands dropped for the read-only
    call."""
    import torch
    _, _, rope, q8, read_only = VARIANTS[variant]
    a = dict(args)
    if q8:
        kq, vq, ks, vs = (x.clone() for x in q8_pools)
        a.update(k_pages=kq, v_pages=vq, k_scale=ks, v_scale=vs)
    else:
        a.update(k_pages=a["k_pages"].clone(), v_pages=a["v_pages"].clone())
    if not rope:
        qb = a.pop("qblock")
        del a["rope_sin"], a["rope_cos"]
        q = torch.zeros((a["block_tables"].shape[0], qb)
                        + tuple(a["q"].shape[1:]), dtype=a["q"].dtype,
                        device=a["q"].device)
        meta = [a[k].tolist() for k in ("q_starts", "q_lens", "w_starts",
                                        "w_flats")]
        for i, (qs, ql, ws, wf) in enumerate(zip(*meta)):
            q[i, :ql] = a["q"][wf + qs - ws:wf + qs - ws + ql]
        a["q"] = q
    if read_only:
        for k in ("new_k", "new_v", "w_starts", "w_flats", "w_ends",
                  "dump_page"):
            del a[k]
    return a


def check_kernel(dev, label, qb, ctx, chunks, inactive,
                 variant="fused_rope", geom=None):
    """Phases 3 and 3d: one instance of the ragged paged attention family
    against its plain version on one dispatch; returns its numbers.
    With ``geom`` (``attention_batch``'s page, d, dtype) the dispatch
    takes that geometry and the check runs untimed.
    Written int8 slots and their scales, V slots and unroped K slots must
    equal the plain version's bit for bit (the plain int8 write is
    ``quantize_kv_int8`` in PyTorch on the card), roped bf16 K slots lie
    within 1 ulp, and no other slot (the dump page included) changes."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.inference.paged_cache import quantize_kv_int8
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    _, _, rope, q8, read_only = VARIANTS[variant]
    args, info = attention_batch(dev, qb, ctx, chunks, inactive,
                                 **(geom or {}))
    info["qblock"] = qb
    q8_pools = None
    if q8:
        kq, ks = quantize_kv_int8(args["k_pages"])
        vq, vs = quantize_kv_int8(args["v_pages"])
        q8_pools = (kq, vq, ks[..., None], vs[..., None])
    fn, plain = (rpa.ragged_paged_attention, rpa.ragged_paged_attention_ref) \
        if read_only else (rpa.fused_ragged_paged_attention,
                           rpa.fused_ragged_paged_attention_ref)
    orig = variant_args(args, variant, q8_pools)
    a_k = variant_args(args, variant, q8_pools)
    a_r = variant_args(args, variant, q8_pools)
    before = dict(rpa.instance_launches)
    out_k = fn(**a_k)
    ran = [k.split(".", 1)[1] for k, n in rpa.instance_launches.items()
           if n > before[k]]
    if len(ran) != 1:
        fail(f"{label} {variant}: instances {ran}, not one launch")
    out_r = plain(**a_r)
    torch.cuda.synchronize()
    # zeros (padding, inactive rows) must be exact: their bound is 0
    err = check_close(f"{label}: kernel out (row, query, head, col)",
                      out_k, out_r)
    ref = out_r.float()
    rel = float(((out_k.float() - ref).abs() / ref.abs().amax(
        dim=-1, keepdim=True).clamp_min(1e-30)).max())
    written = info["written"][:, None, :]               # [P, 1, page]
    pools = ("k_pages", "v_pages") + (("k_scale", "v_scale") if q8 else ())
    k_bits = True
    for name in pools:
        wr = written.expand(a_k[name].shape[:3])
        if not torch.equal(a_k[name][~wr], orig[name][~wr]):
            fail(f"{label}: the kernel changed {name} slots no row writes")
        if read_only:
            continue
        got, want = a_k[name][wr], a_r[name][wr]
        if name == "k_pages" and rope and not q8:
            got, want = got.float(), want.float()
            if not bool(((got - want).abs() <= ulp_bf16(want)).all()):
                fail(f"{label}: written K slots differ from the plain "
                     "version by > 1 ulp")
            k_bits = torch.equal(got, want)
        elif not torch.equal(got, want):
            fail(f"{label}: written {name} slots differ from the plain "
                 "version")
    if geom:
        return dict(max_abs_err=err, rel=rel, instance=ran[0])
    # timing: a fused call rewrites the same slots each time (idempotent)
    ms = time_ms(lambda: fn(**a_k))
    by_kernel = device_ms_by_kernel(lambda: fn(**a_k))
    dev_ms = sum(by_kernel.values())
    write_ms = sum(v for k, v in by_kernel.items() if "kv_write" in k)
    plain_ms = time_ms(lambda: plain(**a_r), iters=5, warmup=1)
    # library yardstick: SDPA over the gathered pages (dequantized to
    # bf16 from int8) with the same mask; the port never calls it
    tables = args["block_tables"].long().clamp(0, info["num_pages"] - 1)
    r = tables.shape[0]
    group = H // HK

    def gathered(pool, sc):
        x = pool[tables]
        if sc is not None:
            x = (x.float() * sc[tables]).to(torch.bfloat16)
        x = x.transpose(2, 3).reshape(r, -1, HK, D)
        return x.repeat_interleave(group, dim=2).transpose(1, 2)
    kg = gathered(a_k["k_pages"], a_k.get("k_scale"))
    vg = gathered(a_k["v_pages"], a_k.get("v_scale"))
    qr = variant_args(args, "fused", None)["q"].transpose(1, 2)
    kpos = torch.arange(kg.shape[2], device=dev)
    qpos = args["q_starts"].long()[:, None] + torch.arange(qb, device=dev)
    mask = (kpos[None, None] <= qpos[:, :, None]) \
        & (kpos[None, None] < args["kv_lens"].long()[:, None, None]) \
        & (torch.arange(qb, device=dev)[None, :, None]
           < args["q_lens"].long()[:, None, None])
    mask = mask[:, None]
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qr, kg, vg, attn_mask=mask))
    bound_ms, bound_by = bound(a_k, info, variant)
    write = "" if read_only else (
        f" write_device_ms={write_ms:.4f} write_bound_ms="
        f"{write_bound(a_k, info, variant)[0]:.5f} (bytes) "
        f"attention_device_ms={dev_ms - write_ms:.4f}")
    print(f"kernel check ({VARIANTS[variant][0]}, {label}): "
          f"instance={ran[0]} qblock={qb} "
          f"rows={info['rows']} tokens={info['tokens']} "
          f"pages={info['num_pages']} out_err={err:.3e} (max err / "
          f"head-vector max {rel:.3e}; tol 1 ulp + {OUT_VEC} x head-vector "
          f"max) written_K_bitwise={bool(k_bits) and not read_only} "
          f"ms={ms:.4f} device_ms={dev_ms:.4f} plain_ms={plain_ms:.3f} "
          f"library_ms={library_ms:.4f} bound_ms={bound_ms:.5f} "
          f"({bound_by}){write}", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def check_kernels(dev, variants=("fused_rope",)):
    """Phases 3 and 3d at both shapes the serving path launches the
    family with: a mixed dispatch (qblock = chunk_block) and a
    decode-only one (qblock 1, contexts of the served requests). Returns
    each instance's JSON entry (without ``launches``) with the mixed
    dispatch's times, in the order of ``variants``."""
    entries = []
    for variant in variants:
        mixed = check_kernel(dev, "mixed", QB, (100, 2001), [QB, QB], True,
                             variant)
        decode = check_kernel(dev, "decode", 1, (64, 545), [], False,
                              variant)
        name, line = VARIANTS[variant][:2]
        entries.append(dict(
            name=name, route="cuda", source=RPA_SOURCE,
            replaces=f"paddle_tpu/ops/ragged_paged_attention.py:{line}",
            **dict(mixed, max_abs_err=max(mixed["max_abs_err"],
                                          decode["max_abs_err"]))))
    return entries


# phase 3f: decode rows at Llama-3-8B's full context, where one long row set
# the time before the split over the sequence
LONG_CTX = (1, FULL_CTX + 1)


def check_long_context(dev):
    """Phase 3f: #12 and #13 (bf16 and int8 pools) on 8 decode rows with
    contexts drawn from 1-8192, at qblock 1 and 32 (the decode-only and
    mixed dispatch widths), timed as phase 3 with its bound. Returns
    {variant: max abs err}."""
    errs = {}
    for qb in (1, QB):
        for variant in ("fused_rope", "fused_rope_q8"):
            r = check_kernel(dev, f"long context qblock {qb}", qb, LONG_CTX,
                             [], False, variant)
            errs[variant] = max(errs.get(variant, 0.0), r["max_abs_err"])
    return errs


# phase 3d: the reference's domain past phase 3's geometry, each point
# through all six call forms of the family at the mixed dispatch
DOMAIN = {"page 64": dict(page=64), "f32": dict(dtype="float32"),
          "head_dim 256": dict(d=256), "head_dim 72": dict(d=72),
          "f16 page 48": dict(page=48, dtype="float16")}


def check_kernel_domain(dev):
    """Phase 3d's widened points: every instance of the family against
    its plain version at pages of 64 and 48 slots, f32 and f16 models,
    head_dim 256 and 72 (int8 pools too), within phase 3's bound, with
    the instance's launches counted. Returns {variant: max abs err}."""
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    errs = {}
    for label, geom in DOMAIN.items():
        line = []
        for variant in VARIANTS:
            before = rpa.launches[variant]
            r = check_kernel(dev, label, QB, (100, 2001), [QB, QB], True,
                             variant, geom)
            if rpa.launches[variant] == before:
                fail(f"{label} {variant}: no kernel launch counted")
            errs[variant] = max(errs.get(variant, 0.0), r["max_abs_err"])
            line.append(f"{variant}={r['max_abs_err']:.3e} "
                        f"({r['instance']})")
        print(f"kernel check (domain, {label}: {geom}): out_err "
              + " ".join(line), flush=True)
    return errs


def llama_model(dev, layers=None, dtype="bfloat16"):
    """Llama-3-8B at full width (``layers`` cut, else full depth) with
    random weights in ``dtype`` from a seeded generator on the card."""
    import torch
    from paddle_tpu_torch.models import LlamaForCausalLM, llama3_8b_config
    cfg = llama3_8b_config()
    if layers:
        cfg = dataclasses.replace(cfg, num_hidden_layers=layers)
    t0 = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(0)
    model = LlamaForCausalLM(cfg, device=dev, dtype=getattr(torch, dtype),
                             generator=gen).eval()
    torch.cuda.synchronize()
    print(f"model: llama3_8b layers={cfg.num_hidden_layers} {dtype} params="
          f"{model.num_params()} init_s={time.perf_counter() - t0:.1f}",
          flush=True)
    return cfg, model


def serving_workload(dev, kv_dtype=None, layers=None, page_size=16,
                     dtype="bfloat16", weight_dtype=None):
    """Llama-3-8B at full width (and depth, unless ``layers``; random
    weights in ``dtype`` from a seeded generator on the card) behind
    ``LlamaServingEngine(max_batch=8, page_size=page_size,
    kv_dtype=kv_dtype, weight_dtype=weight_dtype)``, warmed up, and 8
    prompts of 64-512 tokens. Returns (cfg, model, engine, prompts)."""
    from paddle_tpu_torch.inference import LlamaServingEngine
    cfg, model = llama_model(dev, layers, dtype)
    engine = LlamaServingEngine(model, max_batch=8, page_size=page_size,
                                kv_dtype=kv_dtype, weight_dtype=weight_dtype)
    prompts = serving_prompts(cfg.vocab_size)
    engine.generate([prompts[0][:16]], max_new_tokens=2)   # warm-up
    return cfg, model, engine, prompts


def serving_prompts(vocab):
    """The serving workload: 8 seeded prompts of 64, 128, ..., 512
    tokens."""
    import numpy as np
    rng = np.random.RandomState(0)
    lens = np.linspace(64, 512, 8).astype(int)
    return [rng.randint(0, vocab, n).tolist() for n in lens]


def reset_launches():
    """Set every kernel's launch count to 0."""
    from paddle_tpu_torch.ops import flash_attention as FT
    from paddle_tpu_torch.ops import fused_linear_cross_entropy as FC
    from paddle_tpu_torch.ops import grouped_gemm as GG
    from paddle_tpu_torch.ops import paged_attention as PA
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    from paddle_tpu_torch.quant import kernels as QK
    from paddle_tpu_torch.ops import sampling as SM
    for counts in (rpa.launches, GG.launches, FT.launches, PA.launches,
                   PA.instance_launches, FT.instance_launches,
                   GG.instance_launches, SM.launches,
                   QK.instance_launches, FC.instance_launches):
        for key in counts:
            counts[key] = 0
    QK.launches = FC.launches = 0


def serving_plain_versions():
    """The serving path's plain versions, as ``count_calls`` targets."""
    from paddle_tpu_torch.ops import grouped_gemm as GG
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    from paddle_tpu_torch.quant import kernels as QK
    return [(rpa, "fused_ragged_paged_attention_ref"),
            (rpa, "ragged_paged_attention_ref"),
            (GG, "grouped_gemm_ref"), (GG, "grouped_gemm_q8_ref"),
            (QK, "dequant_matmul_ref")]


def kv8_attention(q, k, v):
    """The no-cache forward's attention as the int8-KV engine computes
    it: K and V through ``quantize_kv_int8`` and back (``int8 * scale``
    per token and kv head), f32 scores, softmax and product."""
    from paddle_tpu_torch.inference.paged_cache import quantize_kv_int8
    from paddle_tpu_torch.models import llama
    (kq, ks), (vq, vs) = quantize_kv_int8(k), quantize_kv_int8(v)
    kd, vd = kq.float() * ks[..., None], vq.float() * vs[..., None]
    return llama.plain_attention(q.float(), kd, vd).to(q.dtype)


def serve(dev, kv_dtype=None, bf16_outs=None, label=None, **workload):
    """Phase 4 (``kv_dtype=None``) and phase 8 (``"int8"``): serve
    Llama-3-8B at full depth through the engine's entry point, every
    launch of the rope-fused attention (#12, or #13 on int8 pools)
    counted and no plain version called; every served token checked
    against the model's own plain forward (its K and V through the int8
    quantizer and back for phase 8). ``workload`` (layers, page_size,
    dtype, weight_dtype) goes to :func:`serving_workload` (phase 9b); with
    int8 weights every projection launches the dequant matmul and the
    plain forward takes its plain version too. All its rows are greedy,
    so nothing is sorted. Returns (launches, outputs, tokens/s)."""
    import torch
    from paddle_tpu_torch.inference import Request
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    from paddle_tpu_torch.quant import kernels as QK
    label = label or ("serve int8-kv" if kv_dtype else "serve")
    key = "fused_rope_q8" if kv_dtype else "fused_rope"
    cfg, model, engine, prompts = serving_workload(dev, kv_dtype,
                                                   **workload)
    finite = []
    hook = model.lm_head.register_forward_hook(
        lambda mod, inp, out: finite.append(torch.isfinite(out).all()))
    reqs = [Request(p, max_new_tokens=NEW) for p in prompts]
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    with count_calls(serving_plain_versions()
                     + [(torch, "sort")]) as plain_calls:
        reset_launches()
        d0 = engine._dispatch_count
        t0 = time.perf_counter()
        outs = engine.generate(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(rpa.launches)
        dq_launches = dict(QK.instance_launches)
    dispatches = engine._dispatch_count - d0
    hook.remove()
    if "sort" in plain_calls:
        fail(f"{label}: an all-greedy run sorted "
             f"{plain_calls.count('sort')} times")
    if plain_calls:
        fail(f"{label}: plain versions ran on the card: "
             f"{sorted(set(plain_calls))}")
    want = {k: 0 for k in launches}
    want[key] = 2 * cfg.num_hidden_layers * dispatches
    if launches != want or not dispatches:
        fail(f"{label}: kernel launches {launches} != {want} (2 x layers x "
             f"dispatches of {key})")
    int8_weights = workload.get("weight_dtype") == "int8"
    per = cfg.num_hidden_layers * dispatches
    n_dq = sum(dq_launches.values())
    if int8_weights != bool(n_dq) or n_dq % per:
        fail(f"{label}: dequant matmul launches {dq_launches} for "
             f"{per} layer dispatches")
    if n_dq:
        print(f"{label}: dequant matmul launches {dq_launches} "
              f"({n_dq // per} a layer a dispatch)", flush=True)
    if not all(bool(f) for f in finite):
        fail(f"{label}: non-finite logits in the serving run")
    for o in outs:
        if len(o) != NEW or not all(0 <= t < cfg.vocab_size for t in o):
            fail(f"{label}: bad output {o}")
    kv_bytes = sum(t.numel() * t.element_size()
                   for t in engine.k_pools + engine.v_pools
                   + engine.k_scales + engine.v_scales)
    # every served token against the model's own plain forward (no
    # cache, plain attention) fed the same tokens: most must be its
    # argmax, the rest near-ties of it
    gaps = []
    with plain_serving_paths():
        if kv_dtype:
            llama.causal_attention = kv8_attention
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
    same = ""
    if bf16_outs is not None:
        eq = sum(a == b for o, ob in zip(outs, bf16_outs)
                 for a, b in zip(o, ob))
        same = f" same_as_bf16_kv={eq}/{n_tok}"
    print(f"{label}: requests={len(prompts)} prompt_tokens="
          f"{sum(map(len, prompts))} new_tokens={n_tok} dispatches="
          f"{dispatches} launches={launches[key]} wall_s={wall:.3f} "
          f"tokens_per_s={n_tok / wall:.1f} ttft_ms_p50="
          f"{1e3 * ttft[len(ttft) // 2]:.1f} ttft_ms_max={1e3 * ttft[-1]:.1f}"
          f" peak_mem_gb={torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"
          f" kv_pool_bytes={kv_bytes} kv_bytes_per_token="
          f"{engine.kv_bytes_per_token} plain_forward_exact={exact}/{n_tok} "
          f"worst_gap={worst:.4f} gap_p90={float(gaps.quantile(0.9)):.4f}"
          f"{same}", flush=True)
    if exact < EXACT_FLOOR * n_tok:
        fail(f"{label}: only {exact}/{n_tok} served tokens are the plain "
             f"forward's argmax (floor {EXACT_FLOOR})")
    if worst > TIE_TOL:
        fail(f"{label}: served token {worst:.3f} below the plain forward's "
             "argmax")
    return launches[key], outs, n_tok / wall


# phase 9's engine paths: keyword arguments, launches per layer per
# dispatch, and the launch-count key (+ "_q8" on int8 pools)
LADDER = {"rope-fused": ({}, 2, "fused_rope"),
          "fused-kv": ({"fused_rope": False}, 2, "fused"),
          "two-op": ({"fused_kv": False}, 1, "ragged")}


@contextlib.contextmanager
def recorded_attention(engine, store):
    """While the first dispatch of ``engine`` runs, append to ``store``
    a copy of each layer's attention output; after it, a copy of every
    pool and sidecar."""
    from paddle_tpu_torch.inference import serving
    names = ("fused_ragged_paged_attention", "ragged_paged_attention")
    saved = [getattr(serving, n) for n in names]
    dispatch = engine._dispatch_rows

    def recording(fn):
        def wrapper(*a, **k):
            out = fn(*a, **k)
            if "pools" not in store:
                store.setdefault("attn", []).append(out.clone())
            return out
        return wrapper

    def first_dispatch(rows):
        out = dispatch(rows)
        if "pools" not in store:
            store["mixed"] = any(n > 1 for _, _, _, n, _, _ in rows)
            store["pools"] = [t.clone() for t in engine.k_pools
                              + engine.v_pools + engine.k_scales
                              + engine.v_scales]
        return out
    for n, fn in zip(names, saved):
        setattr(serving, n, recording(fn))
    engine._dispatch_rows = first_dispatch
    try:
        yield store
    finally:
        for n, fn in zip(names, saved):
            setattr(serving, n, fn)
        del engine._dispatch_rows


# phase 9b: the engine at geometries and dtypes past phase 4's, at
# Llama-3-8B width cut to LADDER_LAYERS layers (2 for the f16 int8 model):
# label -> workload
SERVE_DOMAIN = {"serve page 64": dict(page_size=64),
                "serve f32 model": dict(dtype="float32"),
                "serve f16 int8 weights": dict(dtype="float16",
                                               weight_dtype="int8",
                                               layers=2)}


def serve_domain(dev):
    """Phase 9b: serve phase 4's prompts at 64-slot pages (bf16), with an
    f32 model (pages of 16) and with an f16 model in int8 weights (the
    dequant matmul's cluster instance on f16 x), each through the
    rope-fused kernels with every launch counted, no plain version
    called and every token held against the model's plain forward at
    phase 4's floors. Returns the launches of #12 over the runs."""
    import torch
    launches = 0
    for label, workload in SERVE_DOMAIN.items():
        n, _, _ = serve(dev, label=label, **dict(dict(layers=LADDER_LAYERS),
                                              **workload))
        launches += n
        torch.cuda.empty_cache()
    return launches


def serve_ladder(dev):
    """Phase 9: Llama-3-8B width at LADDER_LAYERS layers serves phase 4's
    prompts through the engine's three attention paths (rope-fused #12 /
    #13, ``fused_rope=False`` #11a / #11b, ``fused_kv=False`` #10 / #9
    after the PyTorch scatter) for both KV dtypes. Per dtype the greedy
    tokens must be identical, and the pools, the sidecars and every
    layer's attention output after the first (mixed) dispatch, and the
    pools after the whole run, bitwise equal; every launch counted (2 a
    layer a dispatch fused, 1 two-op) and no plain version called.
    Returns the launches of each path by its launch-count key."""
    import torch
    from paddle_tpu_torch.inference import LlamaServingEngine, Request
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    cfg, model = llama_model(dev, LADDER_LAYERS)
    prompts = serving_prompts(cfg.vocab_size)
    counts = {}
    for kv_dtype in (None, "int8"):
        runs = {}
        for path, (kw, per_layer, key) in LADDER.items():
            key += "_q8" if kv_dtype else ""
            engine = LlamaServingEngine(model, max_batch=8, page_size=16,
                                        kv_dtype=kv_dtype, **kw)
            reqs = [Request(p, max_new_tokens=NEW) for p in prompts]
            with count_calls(serving_plain_versions()) as plain_calls, \
                    recorded_attention(engine, {}) as first:
                reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs = engine.generate(reqs)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = dict(rpa.launches)
            dispatches = engine._dispatch_count
            label = f"ladder {kv_dtype or 'bf16'} {path}"
            if plain_calls:
                fail(f"{label}: plain versions ran on the card: "
                     f"{sorted(set(plain_calls))}")
            want = {k: 0 for k in launches}
            want[key] = per_layer * LADDER_LAYERS * dispatches
            if launches != want or not first.get("mixed"):
                fail(f"{label}: kernel launches {launches} != {want}, or "
                     "the first dispatch was not a mixed one")
            counts[key] = launches[key]
            pools = engine.k_pools + engine.v_pools + engine.k_scales \
                + engine.v_scales
            runs[path] = (outs, first, pools)
            print(f"{label}: dispatches={dispatches} launches="
                  f"{launches[key]} wall_s={wall:.3f} tokens_per_s="
                  f"{len(prompts) * NEW / wall:.1f}", flush=True)
        outs0, first0, pools0 = runs["rope-fused"]
        for path in ("fused-kv", "two-op"):
            outs, first, pools = runs[path]
            label = f"ladder {kv_dtype or 'bf16'} {path}"
            if outs != outs0:
                fail(f"{label}: greedy tokens differ from the rope-fused "
                     "path's")
            for what, a, b in (("first-dispatch attention", first["attn"],
                                first0["attn"]),
                               ("first-dispatch pools", first["pools"],
                                first0["pools"]),
                               ("final pools", pools, pools0)):
                if len(a) != len(b) or not all(torch.equal(x, y)
                                               for x, y in zip(a, b)):
                    fail(f"{label}: {what} differ from the rope-fused "
                         "path's bit for bit")
        n_attn = len(first0["attn"])
        print(f"ladder {kv_dtype or 'bf16'}: greedy tokens identical, "
              f"first mixed dispatch's attention outputs ({n_attn} layers) "
              f"and pools ({len(pools0)} tensors) bitwise equal across the "
              "three paths; final pools bitwise equal", flush=True)
    return counts


def paged_batch(dev, ctxs, dtype, seed=0, spare=16):
    """Decode rows at Llama-3-8B attention width (32 q / 8 kv heads,
    head_dim 128, page 16): row i attends ``ctxs[i]`` keys over pages
    drawn from a seeded permutation of the pool, its table's tail
    poisoned with ids outside ``[0, P)``; q and pools random in
    ``dtype`` from a seeded generator on the card. Returns the
    wrapper's keyword arguments."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    n_pages = [-(-c // PAGE) for c in ctxs]
    num_pages = sum(n_pages) + spare
    perm = rng.permutation(num_pages)
    width = max(n_pages) + 2
    tables = np.empty((len(ctxs), width), np.int32)
    used = 0
    for i, n in enumerate(n_pages):
        tables[i] = rng.choice([-5, 10 ** 7, num_pages + 11], width)
        tables[i, :n] = perm[used:used + n]
        used += n
    g = torch.Generator(dev).manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, device=dev, dtype=dtype, generator=g)
    return dict(q=rand(len(ctxs), H, D), k_pages=rand(num_pages, HK, PAGE, D),
                v_pages=rand(num_pages, HK, PAGE, D),
                block_tables=torch.from_numpy(tables).to(dev),
                context_lens=torch.tensor(ctxs, dtype=torch.int32,
                                          device=dev))


def paged_bound(args):
    """Least time the card could take for one decode call: the keys each
    row attends (K and V, once), q and out, the live table entries and
    the lens over the memory rate, or 4 x D flops per (query head, key)
    pair over the rate of the pools' type; the larger wins."""
    import torch
    q, kp, lens = args["q"], args["k_pages"], args["context_lens"]
    page = kp.shape[2]
    n = lens.long().clamp(0, args["block_tables"].shape[1] * page)
    keys = int(n.sum())
    entries = int(((n + page - 1) // page).sum())
    nbytes = (2 * keys * HK * D * kp.element_size()
              + 2 * q.numel() * q.element_size() + 4 * (entries + len(n)))
    peak = BF16_FLOPS if kp.dtype == torch.bfloat16 else F32_FLOPS
    return roofline(nbytes, 4 * D * H * keys, peak)


def check_paged(dev, label, ctxs, dtype, against_ragged=False):
    """Phase 3e: the decode paged attention kernel (#4) against its
    plain version on one batch of ``paged_batch`` rows, and, with
    ``against_ragged``, against #10's decode-only launch over the same
    pools (q at position ctx - 1, one query a row); returns its numbers
    and an inactive row's output must be exact zeros."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import paged_attention as PA
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    args = paged_batch(dev, ctxs, dtype)
    before = PA.launches["paged"]
    out = PA.paged_attention(**args)
    if PA.launches["paged"] != before + 1:
        fail(f"paged attention {label}: the wrapper did not launch the "
             "kernel once")
    ref = PA.paged_attention_ref(**args)
    torch.cuda.synchronize()
    if out.dtype != args["q"].dtype or out.shape != args["q"].shape:
        fail(f"paged attention {label}: out {out.dtype} {tuple(out.shape)}")
    err = check_close(f"paged attention {label}: kernel out (row, head, "
                      "col)", out, ref)
    vs_ragged = ""
    if against_ragged:
        lens = args["context_lens"]
        out10 = rpa.ragged_paged_attention(
            args["q"][:, None], args["k_pages"], args["v_pages"],
            args["block_tables"], lens, (lens - 1).clamp_min(0),
            (lens > 0).int())[:, 0]
        torch.cuda.synchronize()
        e10 = check_close(f"paged attention {label}: #4 against #10 "
                          "(row, head, col)", out, out10)
        vs_ragged = f" vs_ragged_err={e10:.3e}"
    ms = time_ms(lambda: PA.paged_attention(**args))
    dev_ms = device_ms(lambda: PA.paged_attention(**args))
    plain_ms = time_ms(lambda: PA.paged_attention_ref(**args), iters=5,
                       warmup=1)
    # library yardstick: SDPA over the gathered K/V (kv heads repeated to
    # H) with a length mask; the port never calls it
    p = args["k_pages"].shape[0]
    tables = args["block_tables"].long().clamp(0, p - 1)
    b = tables.shape[0]

    def gathered(pool):
        x = pool[tables].transpose(2, 3).reshape(b, -1, HK, D)
        return x.repeat_interleave(H // HK, dim=2).transpose(1, 2)
    kg, vg = gathered(args["k_pages"]), gathered(args["v_pages"])
    mask = (torch.arange(kg.shape[2], device=dev)[None, :]
            < args["context_lens"].long()[:, None])[:, None, None, :]
    qs = args["q"][:, :, None]
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qs, kg, vg, attn_mask=mask))
    del kg, vg
    bound_ms, bound_by = paged_bound(args)
    print(f"kernel check (paged_attention, {label}): rows={b} dtype="
          f"{str(dtype).replace('torch.', '')} keys="
          f"{int(args['context_lens'].sum())} pages={p} out_err={err:.3e} "
          f"(tol 1 ulp + {OUT_VEC} x head-vector max){vs_ragged} "
          f"ms={ms:.4f} device_ms={dev_ms:.4f} plain_ms={plain_ms:.3f} "
          f"library_ms={library_ms:.4f} bound_ms={bound_ms:.5f} "
          f"({bound_by})", flush=True)
    return dict(max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def paged_forms(dev, ctxs):
    """The reference's other operand forms of #4 (C9), each ``(label,
    args)``: int64 tables and lens, bf16 q over f32 pools, f32 q over
    bf16 pools, raw int8 pools (values in [-127, 127], q scaled down so
    the scores stay in exp's range), a strided q; and the widest group,
    512 query heads a kv head (H 1024, Hk 2) at head_dim 256 in f32."""
    import torch
    bf = paged_batch(dev, ctxs, torch.bfloat16)
    f32 = paged_batch(dev, ctxs, torch.float32)
    g = torch.Generator(dev).manual_seed(3)
    q8 = {k: torch.randint(-127, 128, bf[k].shape, device=dev, generator=g,
                           dtype=torch.int8) for k in ("k_pages", "v_pages")}
    q = bf["q"]
    yield "int64 tables and lens", dict(
        bf, block_tables=bf["block_tables"].long(),
        context_lens=bf["context_lens"].long())
    yield "bf16 q over f32 pools", dict(f32, q=f32["q"].bfloat16())
    yield "f32 q over bf16 pools", dict(bf, q=q.float())
    yield "raw int8 pools", dict(bf, **q8, q=q / 16)
    yield "strided q", dict(bf, q=torch.cat([q, q], dim=-1)[..., :D])
    n_pages = [-(-c // 8) for c in (0, 1, 300, 129)]
    tables = torch.arange(sum(n_pages), device=dev).split(n_pages)
    width = max(n_pages)
    yield "group 512 (H 1024, Hk 2, head_dim 256, f32)", dict(
        q=torch.randn(4, 1024, 256, device=dev, generator=g),
        k_pages=torch.randn(sum(n_pages), 2, 8, 256, device=dev,
                            generator=g),
        v_pages=torch.randn(sum(n_pages), 2, 8, 256, device=dev,
                            generator=g),
        block_tables=torch.stack([torch.cat([t, t.new_zeros(width - len(t))])
                                  for t in tables]).int(),
        context_lens=torch.tensor([0, 1, 300, 129], dtype=torch.int32,
                                  device=dev))


def check_paged_forms(dev, ctxs):
    """Phase 3e, C9: each of :func:`paged_forms` through the public
    function in exactly one #4 launch and no plain call, against the
    plain version within the kernel bound; returns the largest error."""
    import torch
    from paddle_tpu_torch.ops import paged_attention as PA
    errs = []
    for label, args in paged_forms(dev, ctxs):
        before = PA.launches["paged"]
        inst = dict(PA.instance_launches)
        with count_calls([(PA, "paged_attention_ref")]) as calls:
            out = PA.paged_attention(**args)
        if PA.launches["paged"] != before + 1 or calls:
            fail(f"paged attention, {label}: {PA.launches['paged'] - before}"
                 f" launches, {len(calls)} plain calls (want 1 and 0)")
        ref = PA.paged_attention_ref(**args)
        torch.cuda.synchronize()
        if out.dtype != args["q"].dtype or out.shape != args["q"].shape:
            fail(f"paged attention, {label}: out {out.dtype} "
                 f"{tuple(out.shape)}")
        err = check_close(f"paged attention, {label}: kernel out (row, "
                          "head, col)", out, ref)
        errs.append(err)
        which = [k for k, n in PA.instance_launches.items() if n != inst[k]]
        print(f"kernel check (paged_attention, {label}): instance="
              f"{which[0]} out_err={err:.3e} (tol 1 ulp + {OUT_VEC} x "
              "head-vector max)", flush=True)
    torch.cuda.empty_cache()
    return max(errs)


def check_paged_kernel(dev):
    """Phase 3e: #4 at phase 3's decode-only shape (8 rows, contexts
    64-544, bf16 and f32; the bf16 pools through #10 too), at Llama-3-8B's
    full context (32 rows, bf16, contexts over 1-8192 and an inactive
    row) and in the reference's other operand forms (C9,
    :func:`check_paged_forms`). Returns #4's JSON entry (without
    ``launches``), with the full-context times, the shape phase 10
    runs."""
    import numpy as np
    import torch
    rng = np.random.RandomState(0)
    ctxs = rng.randint(64, 545, 8).tolist()
    # 1, a page multiple, the whole context, an inactive row, the rest
    # uniform over 1..FULL_CTX
    full_ctxs = [1, FULL_CTX // 2, FULL_CTX, 0] \
        + rng.randint(1, FULL_CTX + 1, 28).tolist()
    errs = []
    for dtype in (torch.bfloat16, torch.float32):
        r = check_paged(dev, f"decode {str(dtype).replace('torch.', '')}",
                        ctxs, dtype, against_ragged=dtype == torch.bfloat16)
        errs.append(r["max_abs_err"])
    full = check_paged(dev, "full context", full_ctxs, torch.bfloat16)
    full.pop("device_ms")
    # the forms' errors scale with their values (int8 pools: up to 127),
    # so they stand apart from the main shapes'
    forms_err = check_paged_forms(dev, ctxs)
    torch.cuda.empty_cache()
    return dict(name="paged_attention", route="cuda", source=PA_SOURCE,
                replaces=PA_REPLACES,
                **dict(full, max_abs_err=max(errs + [full["max_abs_err"]]),
                       forms_max_abs_err=forms_err))


def decode_cache(dev):
    """Phase 10: the slice's path. One ``PagedKVCache`` at Llama-3-8B's
    attention width on the card; 32 sequences admitted with seeded
    prompts of 1-8160 tokens and their K/V written; 32 decode steps of
    ``extend`` + ``write`` + ``attend``; half the sequences released and
    16 new ones admitted on the recycled pages, 8 more steps. Every
    ``attend`` must launch #4 once and never the plain version; the
    first and last step of each stretch are held against the plain
    version on the same pools. Returns #4's launches."""
    import numpy as np
    import torch
    from paddle_tpu_torch.inference import PagedKVCache
    from paddle_tpu_torch.ops import paged_attention as PA
    rng = np.random.RandomState(10)
    g = torch.Generator(dev).manual_seed(10)

    def rand(*shape):
        return torch.randn(*shape, device=dev, dtype=torch.bfloat16,
                           generator=g)
    torch.cuda.reset_peak_memory_stats()
    cache = PagedKVCache(CACHE_PAGES, PAGE, HK, D, dtype=torch.bfloat16,
                         device=dev)
    pool_bytes = sum(t.numel() * t.element_size()
                     for t in (cache.k_pages, cache.v_pages))

    def admit(sids):
        lens = rng.randint(1, CACHE_PROMPT + 1, len(sids))
        for sid, n in zip(sids, lens.tolist()):
            cache.admit(sid, n)
            cache.write(sid, rand(n, HK, D), rand(n, HK, D))
        return int(lens.sum())

    live = list(range(CACHE_ROWS))
    prompt_tokens = admit(live)
    plain_calls, times, checked = [], [], 0
    launched = []

    def stretch(steps):
        nonlocal checked
        for step in range(steps):
            for sid in live:
                cache.extend(sid, 1)
                cache.write(sid, rand(1, HK, D), rand(1, HK, D))
            q = rand(len(live), H, D)
            before = PA.launches["paged"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with count_calls([(PA, "paged_attention_ref")]) as calls:
                out = cache.attend(live, q)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            plain_calls.extend(calls)
            launched.append(PA.launches["paged"] - before)
            if tuple(out.shape) != (len(live), H, D) \
                    or not bool(torch.isfinite(out).all()):
                fail(f"decode cache: bad attend output at step {step}")
            if step in (0, steps - 1):
                ref = cache.attend(live, q, use_kernel=False)
                check_close(f"decode cache step {step}: attend (row, head, "
                            "col)", out, ref)
                checked += 1

    reset_launches()
    stretch(CACHE_STEPS)
    released = set()
    for sid in live[:CACHE_ROWS // 2]:
        released.update(cache.export_table(sid)[0])
        cache.release(sid)
    new = list(range(CACHE_ROWS, CACHE_ROWS + CACHE_ROWS // 2))
    live = live[CACHE_ROWS // 2:] + new
    refill_tokens = admit(new)
    reused = len(released & {p for s in new
                             for p in cache.export_table(s)[0]})
    if not reused:
        fail("decode cache: the new sequences got none of the released "
             "pages")
    stretch(CACHE_REFILL_STEPS)
    launches = PA.launches["paged"]
    attends = CACHE_STEPS + CACHE_REFILL_STEPS
    if plain_calls:
        fail(f"decode cache: the plain version ran on the card "
             f"({len(plain_calls)} calls)")
    if launched != [1] * attends or launches != attends:
        fail(f"decode cache: #4 launches per attend {launched} (want one "
             "each)")
    if PA.instance_launches["tensor-core"] < attends:
        fail(f"decode cache: #4's tensor-core instance ran "
             f"{PA.instance_launches['tensor-core']} of {attends} attends")
    dev_ms = device_ms(lambda: cache.attend(live, rand(len(live), H, D)),
                       iters=5)
    keys = sum(cache.context_len(s) for s in live)
    attend_ms = 1e3 * sum(times) / len(times)
    print(f"decode cache: pages={CACHE_PAGES} pool_bytes={pool_bytes} "
          f"rows={len(live)} prompt_tokens={prompt_tokens} "
          f"refill_prompt_tokens={refill_tokens} recycled_pages={reused} "
          f"attends={attends} launches={launches} "
          f"checked_steps={checked} final_keys={keys} attend_ms_mean="
          f"{attend_ms:.4f} attend_ms_max={1e3 * max(times):.4f} "
          f"device_ms={dev_ms:.4f} host_share="
          f"{max(0.0, 1 - dev_ms / attend_ms):.3f} peak_mem_gb="
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f}", flush=True)
    return launches


def flash_registers():
    """``ptxas -v`` lines of the flash kernels, of the ragged attention's
    tensor-core instance and write launch, of the decode paged
    attention's (#4) instances, of the loss kernel's tensor-core instance
    and of the GEMM kernels' cluster instances: registers and spills of
    each instance, from the builds' logs."""
    import re
    from paddle_tpu_torch.ops import _build
    lines = []
    for mangled, what in sorted(_build.ptxas_report(
            "ragged_paged_attention").items()):
        m = re.search(r"attention_tcILb(\d)ELb(\d)E(?:13(__nv_bfloat16)|"
                      r"6(__half))Li(\d+)E", mangled)
        if m:
            lines.append(f"ptxas: attention_tc<{m.group(1)}, {m.group(2)}, "
                         f"{m.group(3) or m.group(4)}, {m.group(5)}>: {what}")
        m = re.search(r"kv_write_kernelILb(\d)ELb(\d)E(?:13(__nv_bfloat16)|"
                      r"6(__half)|(f))E", mangled)
        if m:
            t = m.group(3) or m.group(4) or "float"
            lines.append(f"ptxas: kv_write_kernel<{m.group(1)}, "
                         f"{m.group(2)}, {t}>: {what}")
    for mangled, what in sorted(_build.ptxas_report(
            "paged_attention").items()):
        m = re.search(r"decode_tcI(\w+?)Li(\d+)E", mangled)
        if m:
            pool = "bf16" if "bfloat16" in m.group(1) else "f16"
            q = "f32" if m.group(1).endswith("f") else pool
            lines.append(f"ptxas: paged decode_tc<pools {pool}, q {q}, "
                         f"{m.group(2)}>: {what}")
        m = re.search(r"decode_generalI([fa])E", mangled)
        if m:
            pool = {"f": "f32", "a": "int8"}[m.group(1)]
            lines.append(f"ptxas: paged decode_general<pools {pool}>: "
                         f"{what}")
    for mangled, what in sorted(_build.ptxas_report(
            "flash_attention").items()):
        m = re.search(r"(flash_[a-z_]+)I(?:Li(\d+)E|(f)E|6(__half)E|"
                      r"13(__nv_bfloat16)E)", mangled)
        arg = next(g for g in m.groups()[1:] if g) if m else ""
        name = f"{m.group(1)}<{'float' if arg == 'f' else arg}>" if m \
            else mangled
        lines.append(f"ptxas: {name}: {what}")
    for lib, kernel in (("dequant_matmul", "dq_cluster_kernel"),
                        ("grouped_gemm", "q8_cluster_kernel")):
        for mangled, what in sorted(_build.ptxas_report(lib).items()):
            m = re.search(kernel + r"I(?:6(__half)|13(__nv_bfloat16))"
                          r"Li(\d)E", mangled)
            if m:
                lines.append(f"ptxas: {kernel}<{m.group(1) or m.group(2)}, "
                             f"{m.group(3)}>: {what}")
    for mangled, what in sorted(_build.ptxas_report("grouped_gemm").items()):
        m = re.search(r"float_cluster_kernelI(?:6(__half)|13(__nv_bfloat16))"
                      r"Li(\d)ELb(\d)E", mangled)
        if m:
            t = m.group(1) or m.group(2)
            lines.append(f"ptxas: float_cluster_kernel<{t}, {m.group(3)}, "
                         f"k-major {m.group(4)}>: {what}")
    for mangled, what in sorted(_build.ptxas_report(
            "fused_linear_cross_entropy").items()):
        m = re.search(r"(linear_ce_fwd_tc)ILb(\d)ELb(\d)E", mangled)
        if m:
            lines.append(f"ptxas: {m.group(1)}<h f32: {m.group(2)}, w f32: "
                         f"{m.group(3)}>: {what}")
    return lines


def attention_pairs(b, h, sq, sk, causal):
    """Unmasked (query, key) pairs of one attention call."""
    if not causal:
        return b * h * sq * sk
    off = sk - sq
    return b * h * sum(min(sk, i + off + 1) for i in range(sq))


def roofline(nbytes, ops, peak):
    """(bound ms, what bounds it): the larger of the bytes over the
    memory rate and the operations over ``peak``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def flash_bounds(b, sq, sk, causal):
    """Bound of each flash kernel: q/k/v (and dO, lse, delta) read once,
    outputs written once, bf16; 4/6/8 x D flops per unmasked pair."""
    pairs = attention_pairs(b, H, sq, sk, causal)
    q_b, kv_b, rows = b * sq * H * D * 2, b * sk * HK * D * 2, b * H * sq * 4
    return {"forward": roofline(2 * q_b + 2 * kv_b + rows, 4 * D * pairs,
                                BF16_FLOPS),
            "dq": roofline(3 * q_b + 2 * kv_b + 2 * rows, 6 * D * pairs,
                           BF16_FLOPS),
            "dkv": roofline(2 * q_b + 4 * kv_b + 2 * rows, 8 * D * pairs,
                            BF16_FLOPS)}


def flash_case(dev, label, b, sq, sk, causal, seed, timed, d=D,
               dtype="bfloat16"):
    """The three flash kernels against the plain versions on one batch
    at the Llama-3-8B head counts (head_dim ``d``, ``dtype`` q/k/v); the
    backward kernels get the plain forward's lse and delta, so each
    kernel is checked alone. Prints the instance each kernel ran
    (``kernel_instance``'s rule). Returns ({kernel: max abs err},
    {kernel: timings} if ``timed``)."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import flash_attention as FT
    g = torch.Generator(dev).manual_seed(seed)
    bf = dict(device=dev, dtype=getattr(torch, dtype), generator=g)
    q, do = torch.randn(b, sq, H, d, **bf), torch.randn(b, sq, H, d, **bf)
    k, v = torch.randn(b, sk, HK, d, **bf), torch.randn(b, sk, HK, d, **bf)
    scale = 1.0 / math.sqrt(d)
    args = (q, k, v, causal, scale)
    before = dict(FT.instance_launches)
    out, lse = FT._launch_forward(*args)
    out_r, lse_r = FT.flash_attention_fwd_ref(*args)
    delta = FT.attention_delta(out_r, do)
    bargs = (q, k, v, do, lse_r, delta, causal, scale)
    dq = FT._launch_dq(*bargs)
    dk, dv = FT._launch_dkv(*bargs)
    dq_r, dk_r, dv_r = FT.flash_attention_bwd_ref(*bargs)
    torch.cuda.synchronize()
    err = {"forward": check_close(f"flash {label} out", out, out_r),
           "dq": check_close(f"flash {label} dq", dq, dq_r, GRAD_FLOOR),
           "dkv": max(check_close(f"flash {label} dk", dk, dk_r, GRAD_FLOOR),
                      check_close(f"flash {label} dv", dv, dv_r,
                                  GRAD_FLOOR))}
    lse_err = float((lse - lse_r).abs().max())
    if not lse_err <= LSE_ABS:
        fail(f"flash {label}: lse differs by {lse_err} > {LSE_ABS}")
    if any(x.dtype != q.dtype for x in (out, dq, dk, dv)):
        fail(f"flash {label}: outputs not in the inputs' dtype {q.dtype}")
    ran = sorted(k_ for k_, n in FT.instance_launches.items()
                 if n > before[k_])
    print(f"flash check ({label}): B={b} Sq={sq} Sk={sk} D={d} {dtype} "
          f"causal={causal} instances={','.join(ran)} "
          f"out_err={err['forward']:.3e} lse_err={lse_err:.3e} "
          f"dq_err={err['dq']:.3e} dkv_err={err['dkv']:.3e}", flush=True)
    if len(ran) != 3:
        fail(f"flash {label}: instances {ran}, not one per kernel")
    if not timed:
        if dtype != "bfloat16" or d not in (64, 128):
            print(f"flash {label} times (general instance): forward_ms="
                  f"{time_ms(lambda: FT._launch_forward(*args), 5, 1):.4f}"
                  f" dq_ms={time_ms(lambda: FT._launch_dq(*bargs), 5, 1):.4f}"
                  f" dkv_ms="
                  f"{time_ms(lambda: FT._launch_dkv(*bargs), 5, 1):.4f}",
                  flush=True)
        return err, None
    t = {"forward": time_ms(lambda: FT._launch_forward(*args)),
         "dq": time_ms(lambda: FT._launch_dq(*bargs)),
         "dkv": time_ms(lambda: FT._launch_dkv(*bargs))}
    dev_t = {"forward": device_ms(lambda: FT._launch_forward(*args)),
             "dq": device_ms(lambda: FT._launch_dq(*bargs)),
             "dkv": device_ms(lambda: FT._launch_dkv(*bargs))}
    plain_fwd = time_ms(lambda: FT.flash_attention_fwd_ref(*args), iters=3,
                        warmup=1)
    plain_bwd = time_ms(lambda: FT.flash_attention_bwd_ref(*bargs), iters=3,
                        warmup=1)
    # library yardstick (never called by the port): SDPA with GQA on the
    # head-major views, forward alone and forward + backward
    qh, kh, vh, doh = (x.transpose(1, 2) for x in (q, k, v, do))
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=causal, enable_gqa=True))
    qg, kg, vg = (x.detach().requires_grad_() for x in (qh, kh, vh))

    def lib_step():
        F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal,
                                       enable_gqa=True).backward(doh)
    lib_both = time_ms(lib_step)
    bounds = flash_bounds(b, sq, sk, causal)
    timing = {}
    for name in ("forward", "dq", "dkv"):
        bound_ms, bound_by = bounds[name]
        timing[name] = dict(
            ms=t[name], plain_ms=plain_fwd if name == "forward" else plain_bwd,
            library_ms=lib_fwd if name == "forward" else lib_both - lib_fwd,
            bound_ms=bound_ms, bound_by=bound_by, device_ms=dev_t[name],
            instance=[k_ for k_ in ran if k_.startswith(name + ".")][0])
        print(f"flash {name}: instance={timing[name]['instance']} "
              f"ms={t[name]:.4f} device_ms={dev_t[name]:.4f} plain_ms="
              f"{timing[name]['plain_ms']:.3f} library_ms="
              f"{timing[name]['library_ms']:.4f} bound_ms={bound_ms:.5f} "
              f"({bound_by})", flush=True)
    print(f"flash library: sdpa_fwd_ms={lib_fwd:.4f} sdpa_fwd_bwd_ms="
          f"{lib_both:.4f}", flush=True)
    return err, timing


# phase 3b: the general instance (f32 FMAs) at points of the reference's
# domain past bf16 head_dim 64/128: label -> (b, sq, sk, causal, d, dtype)
FLASH_DOMAIN = {"f32 d128": (1, 512, 512, True, 128, "float32"),
                "bf16 d96": (1, 512, 512, True, 96, "bfloat16"),
                "bf16 d256": (1, 256, 256, False, 256, "bfloat16"),
                "f16 d64": (1, 256, 384, True, 64, "float16")}


def check_flash(dev):
    """Phase 3b, flash attention: the Llama-3-8B training batch (timed;
    the forward is the wgmma instance), a non-causal batch and a causal
    one with fewer queries than keys, then the general instance at
    FLASH_DOMAIN's points. Returns the three kernels' JSON entries
    (without ``launches``)."""
    from paddle_tpu_torch.ops import _build
    err, timing = flash_case(dev, "train", TRAIN_B, TRAIN_S, TRAIN_S, True,
                             seed=1, timed=True)
    report = _build.ptxas_report("flash_attention")
    for name in ("dq", "dkv"):
        regs = [v for k, v in report.items()
                if f"flash_{name}_wgmmaILi128E" in k]
        print(f"flash {name}: instance={timing[name]['instance']} registers "
              f"(D 128, at launch): {', '.join(regs)}", flush=True)
    for label, args in (("non-causal", (1, 512, 512, False)),
                        ("short-q", (1, 256, 768, True))):
        e, _ = flash_case(dev, label, *args, seed=2, timed=False)
        err = {k: max(err[k], e[k]) for k in err}
    for label, (b, sq, sk, causal, d, dtype) in FLASH_DOMAIN.items():
        e, _ = flash_case(dev, label, b, sq, sk, causal, seed=3,
                          timed=False, d=d, dtype=dtype)
        err = {k: max(err[k], e[k]) for k in err}
    return [dict(name=FA_NAMES[k], route="cuda", source=FA_SOURCE,
                 replaces=FA_REPLACES[k], max_abs_err=err[k], **timing[k])
            for k in ("forward", "dq", "dkv")]


def ce_point(dev, label, h, w, lab, want, timed=False):
    """The loss and its gradients through the public function against
    the plain path on one set of inputs: the loss within LOSS_REL; f32
    gradients within GRAD_REL of their largest value, 16-bit ones within
    phase 3's bound (1 bf16 ulp plus 2^-10 of the row's largest value: a
    16-bit gradient rounds where an lse 1e-7 away rounds otherwise). The
    forward must launch the ``want`` instance; with ``timed``, the
    kernel's time by CUDA events and its device time. Returns the largest
    lse/pick error and the times."""
    import torch
    from paddle_tpu_torch.ops import fused_linear_cross_entropy as FC

    def loss_and_grads():
        hg, wg = h.clone().requires_grad_(), w.clone().requires_grad_()
        loss = FC.fused_linear_cross_entropy(hg, wg, lab)
        loss.backward()
        return loss.detach(), hg.grad, wg.grad
    before = dict(FC.instance_launches)
    loss_k, dh_k, dw_k = loss_and_grads()
    ran = [k for k, n in FC.instance_launches.items() if n > before[k]]
    if ran != [want]:
        fail(f"loss {label}: instances {ran}, not {want}")
    lse, pick = FC._launch(h, w, lab)
    lse_r, pick_r = FC.fused_linear_cross_entropy_ref(h, w, lab,
                                                      FC.default_chunk())
    err = max(float((lse - lse_r).abs().max()),
              float((pick - pick_r).abs().max()))
    with plain_paths():
        loss_p, dh_p, dw_p = loss_and_grads()
    rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    if not rel <= LOSS_REL:
        fail(f"loss {label}: {float(loss_k)} vs plain {float(loss_p)}: "
             f"{rel:.3e}")
    for name, a, b in (("dh", dh_k, dh_p), ("dW", dw_k, dw_p)):
        if a.dtype != b.dtype or a.dtype != (h if name == "dh" else w).dtype:
            fail(f"loss {label}: {name} in {a.dtype}")
        if a.dtype == torch.float32:
            e = float((a - b).abs().max()) / float(b.abs().max())
            if not e <= GRAD_REL:
                fail(f"loss {label}: {name} differs from the plain path by "
                     f"{e:.3e} of its max")
        else:
            check_close(f"loss {label}: {name} (row, column)", a, b)
    line = (f"loss check ({label}): N={h.shape[0]} D={h.shape[1]} "
            f"V={w.shape[0]} {h.dtype} hidden {w.dtype} weight "
            f"instance={want} lse_pick_err={err:.3e} loss_rel={rel:.3e}")
    times = {}
    if timed:
        times = dict(ms=time_ms(lambda: FC._launch(h, w, lab), 3, 1),
                     device_ms=device_ms(lambda: FC._launch(h, w, lab), 3))
        line += f" ms={times['ms']:.3f} device_ms={times['device_ms']:.3f}"
    print(line, flush=True)
    return err, times


def check_ce(dev):
    """Phase 3b, the loss: the fused linear cross-entropy kernel (its
    tensor-core instance) against the plain chunked version at N = D =
    4096, V = 128256 in f32, 5% of rows at ignore_index; then the loss
    and its gradients through the kernel path against the plain path;
    then ``ce_point`` at bf16 hidden and weight (same shape, timed) and
    at CE_GENERAL (D % 8 != 0: the general instance, f16 hidden, f32
    weight). Returns the JSON entry (without ``launches``)."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import fused_linear_cross_entropy as FC
    g = torch.Generator(dev).manual_seed(3)
    h = torch.randn(CE_N, CE_D, device=dev, generator=g)
    w = torch.randn(CE_V, CE_D, device=dev, generator=g) * 0.02
    lab = torch.randint(0, CE_V, (CE_N,), device=dev, generator=g)
    lab[torch.rand(CE_N, device=dev, generator=g) < CE_IGNORED] = -100
    chunk = FC.default_chunk()
    before = dict(FC.instance_launches)
    lse, pick = FC._launch(h, w, lab)
    ran = [k for k, n in FC.instance_launches.items() if n > before[k]]
    lse_r, pick_r = FC.fused_linear_cross_entropy_ref(h, w, lab, chunk)
    torch.cuda.synchronize()
    if ran != ["tensor-core"]:
        fail(f"loss kernel: instances {ran}, not the tensor-core one")
    errs = []
    for name, got, ref in (("lse", lse, lse_r), ("pick", pick, pick_r)):
        if not torch.isfinite(got).all():
            fail(f"loss kernel: non-finite {name}")
        rel = float(((got - ref).abs() / ref.abs().clamp_min(1.0)).max())
        if not rel <= CE_REL:
            fail(f"loss kernel: {name} differs by {rel:.3e} (relative) > "
                 f"{CE_REL}")
        errs.append(float((got - ref).abs().max()))

    def loss_and_grads():
        hg, wg = h.clone().requires_grad_(), w.clone().requires_grad_()
        loss = FC.fused_linear_cross_entropy(hg, wg, lab)
        loss.backward()
        return loss.detach(), hg.grad, wg.grad
    loss_k, dh_k, dw_k = loss_and_grads()
    # the backward is the plain chunked code: fed the kernel's lse it
    # gives the same gradients bit for bit
    valid = (lab != -100).float().sum()
    gn = torch.ones(CE_N, device=dev) / valid
    dh_b, dw_b = FC.linear_cross_entropy_backward(h, w, lab, lse, gn, chunk,
                                                  -100)
    if not (torch.equal(dh_k, dh_b) and torch.equal(dw_k, dw_b)):
        fail("loss kernel path: gradients differ from the chunked backward")
    with plain_paths():
        loss_p, dh_p, dw_p = loss_and_grads()
    rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    if not rel <= LOSS_REL:
        fail(f"loss {float(loss_k)} vs plain {float(loss_p)}: {rel:.3e}")
    for name, a, b in (("dh", dh_k, dh_p), ("dW", dw_k, dw_p)):
        e = float((a - b).abs().max()) / float(b.abs().max())
        if not e <= GRAD_REL:
            fail(f"loss {name} differs from the plain path by {e:.3e} of "
                 f"its max")
    del dh_k, dw_k, dh_b, dw_b, dh_p, dw_p
    run = lambda: FC._launch(h, w, lab)  # noqa: E731
    ms = time_ms(run, iters=3, warmup=1)
    dev_ms = device_ms(run, iters=3)
    plain_ms = time_ms(lambda: FC.fused_linear_cross_entropy_ref(
        h, w, lab, chunk), iters=3, warmup=1)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    library_ms = time_ms(lambda: F.cross_entropy(F.linear(h, w), lab,
                                                 ignore_index=-100),
                         iters=3, warmup=1)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    nbytes = 4 * CE_N * CE_D + 4 * CE_V * CE_D + 8 * CE_N + 8 * CE_N
    ops = 2 * CE_N * CE_D * CE_V
    # what the kernel does: three TF32 products on the tensor cores; an
    # f32 product on the CUDA cores would take the second bound
    bound_ms, bound_by = roofline(nbytes, 3 * ops, TF32_FLOPS)
    f32_bound_ms, _ = roofline(nbytes, ops, F32_FLOPS)
    regs = [v for k, v in _build.ptxas_report(
        "fused_linear_cross_entropy").items() if "linear_ce_fwd_tcILb1ELb1E" in k]
    print(f"loss kernel check: N={CE_N} D={CE_D} V={CE_V} "
          f"ignored={int(CE_N - valid)} instance={ran[0]} registers="
          f"{','.join(regs)} lse_err={errs[0]:.3e} pick_err={errs[1]:.3e} "
          f"loss={float(loss_k):.6f} plain_loss={float(loss_p):.6f} "
          f"ms={ms:.3f} device_ms={dev_ms:.3f} plain_ms={plain_ms:.3f} "
          f"library_ms={library_ms:.3f} bound_ms={bound_ms:.3f} "
          f"({bound_by}, 3xTF32) f32_bound_ms={f32_bound_ms:.3f}",
          flush=True)
    err16, _ = ce_point(dev, "bf16", h.bfloat16(), w.bfloat16(), lab,
                        "tensor-core", timed=True)
    del h, w
    torch.cuda.empty_cache()
    n, d, v = CE_GENERAL
    h = torch.randn(n, d, device=dev, generator=g).half()
    w = torch.randn(v, d, device=dev, generator=g) * 0.02
    lab = torch.randint(0, v, (n,), device=dev, generator=g)
    lab[:8] = -100
    err_g, _ = ce_point(dev, "general", h, w, lab, "general")
    return dict(name="fused_linear_cross_entropy_forward", route="cuda",
                source="paddle_tpu_torch/csrc/fused_linear_cross_entropy.cu",
                replaces="paddle_tpu/ops/fused_linear_cross_entropy.py:220",
                max_abs_err=max(errs + [err16, err_g]), ms=ms,
                device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, f32_bound_ms=f32_bound_ms,
                library_ms=library_ms, instance=ran[0])


@contextlib.contextmanager
def plain_paths():
    """Route flash attention and the loss to their plain versions on the
    card (the comparison runs only)."""
    from paddle_tpu_torch.ops import flash_attention as FT
    from paddle_tpu_torch.ops import fused_linear_cross_entropy as FC
    saved = FT._launch_forward, FT._launch_backward, FC._launch
    FT._launch_forward = FT.flash_attention_fwd_ref
    FT._launch_backward = FT.flash_attention_bwd_ref
    FC._launch = lambda h, w, lab: FC.fused_linear_cross_entropy_ref(
        h, w, lab, FC.default_chunk())
    try:
        yield
    finally:
        FT._launch_forward, FT._launch_backward, FC._launch = saved


@contextlib.contextmanager
def counted_plain_versions():
    """Count every call of the training path's plain versions (flash
    forward/backward, the loss, the plain attention composition)."""
    from paddle_tpu_torch.nn.functional import attention as FA
    from paddle_tpu_torch.ops import flash_attention as FT
    from paddle_tpu_torch.ops import fused_linear_cross_entropy as FC
    with count_calls([(FT, "flash_attention_fwd_ref"),
                      (FT, "flash_attention_bwd_ref"),
                      (FC, "fused_linear_cross_entropy_ref"),
                      (FA, "_naive_attention")]) as calls:
        yield calls


@contextlib.contextmanager
def count_calls(targets):
    """Count every call of the functions ``(module, name)`` in
    ``targets`` (looked up as module globals by their callers)."""
    calls = []
    saved = [getattr(m, n) for m, n in targets]

    def counted(name, fn):
        def wrapper(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapper
    for (m, n), fn in zip(targets, saved):
        setattr(m, n, counted(n, fn))
    try:
        yield calls
    finally:
        for (m, n), fn in zip(targets, saved):
            setattr(m, n, fn)


def training_model(dev, layers):
    """Llama-3-8B width cut to ``layers`` layers, f32 weights drawn from
    a seeded generator on the card, and one fixed seeded batch of
    ``[TRAIN_B, TRAIN_S + 1]`` token ids."""
    import numpy as np
    from paddle_tpu_torch.examples.llama_pretrain import build_model
    model = build_model("8b", layers, dev, seed=0)
    ids = np.random.RandomState(0).randint(
        0, model.config.vocab_size, (TRAIN_B, TRAIN_S + 1)).astype(np.int64)
    return model, ids


def train(dev):
    """Phase 5: train the 8-layer model through the recipe's entry
    point; returns the launches of each kernel in that run."""
    import torch
    from paddle_tpu_torch.examples import llama_pretrain
    from paddle_tpu_torch.ops import flash_attention as FT
    from paddle_tpu_torch.ops import fused_linear_cross_entropy as FC
    t0 = time.perf_counter()
    model, ids = training_model(dev, TRAIN_LAYERS)
    torch.cuda.synchronize()
    print(f"model: llama3_8b width, layers={TRAIN_LAYERS} params="
          f"{model.num_params()} init_s={time.perf_counter() - t0:.1f}",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    with counted_plain_versions() as plain_calls:
        for key in FT.launches:
            FT.launches[key] = 0
        FC.launches = 0
        res = llama_pretrain.train(
            model, TRAIN_STEPS, TRAIN_B, TRAIN_S, lr=3e-4, weight_decay=0.1,
            use_amp=True, source=itertools.repeat(ids),
            log=lambda line: print("train: " + line, flush=True))
        torch.cuda.synchronize()
        launches = dict(FT.launches, ce=FC.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if plain_calls:
        fail(f"plain versions ran on the card: {sorted(set(plain_calls))}")
    want = dict(forward=TRAIN_STEPS * TRAIN_LAYERS,
                dq=TRAIN_STEPS * TRAIN_LAYERS,
                dkv=TRAIN_STEPS * TRAIN_LAYERS, ce=TRAIN_STEPS)
    if launches != want:
        fail(f"kernel launches {launches} != {want}")
    losses = res["losses"]
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"loss did not fall: {losses}")
    steady = res["step_s"][2:]
    step_s = sum(steady) / len(steady)
    tokens = TRAIN_B * TRAIN_S
    tflops = model.flops_per_token(TRAIN_S) * tokens / step_s / 1e12
    print(f"train: layers={TRAIN_LAYERS} batch={TRAIN_B} seq={TRAIN_S} "
          f"steps={TRAIN_STEPS} loss_first={losses[0]:.4f} loss_last="
          f"{losses[-1]:.4f} step_ms={step_s * 1e3:.1f} (mean of steps "
          f"3-{TRAIN_STEPS}) tokens_per_s={tokens / step_s:.0f} "
          f"tflops={tflops:.1f} peak_mem_gb={peak:.2f} launches={launches}",
          flush=True)
    return launches


def compare_step(dev, use_amp=True):
    """Phase 5b: one step (loss and gradients, no update) of a 2-layer
    model at full width through the kernels, against the same step
    through the plain versions, on the same weights and batch: under
    bf16 ``auto_cast`` (the flash kernels' tensor-core instances), and
    with ``use_amp=False`` in f32 (their general instance)."""
    import contextlib as cl
    import torch
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.ops import flash_attention as FT
    model, ids = training_model(dev, 2)
    x = torch.from_numpy(ids[:, :-1]).to(dev)
    y = torch.from_numpy(ids[:, 1:]).to(dev)
    names = ["lm_head.weight", "model.layers.0.self_attn.q_proj.weight",
             "model.embed_tokens.weight"]
    params = dict(model.named_parameters())

    def step():
        with (amp.auto_cast(dtype="bfloat16") if use_amp
              else cl.nullcontext()):
            loss, _ = model(x, y)
        loss.backward()
        grads = [params[n].grad.clone() for n in names]
        model.zero_grad(set_to_none=True)
        return loss.item(), grads
    before = dict(FT.instance_launches)
    loss_k, g_k = step()
    ran = sorted(k for k, n in FT.instance_launches.items()
                 if n > before[k])
    with plain_paths():
        loss_p, g_p = step()
    rel = abs(loss_k - loss_p) / abs(loss_p)
    line = [f"loss={loss_k:.5f} plain_loss={loss_p:.5f} rel={rel:.2e}"]
    if not rel <= STEP_LOSS_REL:
        fail(f"2-layer step: loss {loss_k} vs plain {loss_p}")
    for n, a, b in zip(names, g_k, g_p):
        cos = float(torch.nn.functional.cosine_similarity(
            a.flatten().double(), b.flatten().double(), dim=0))
        ratio = float(a.double().norm() / b.double().norm())
        line.append(f"{n}: cos={cos:.6f} norm_ratio={ratio:.5f}")
        if not (cos >= GRAD_COS and abs(ratio - 1) <= GRAD_NORM):
            fail(f"2-layer step: grad of {n} cos {cos} norm ratio {ratio}")
    want = ["dkv.wgmma", "dq.wgmma", "forward.wgmma"] if use_amp \
        else ["dkv.general", "dq.general", "forward.general"]
    if ran != want:
        fail(f"2-layer step: flash instances {ran} != {want}")
    print(f"compare step (2 layers, {'bf16 auto_cast' if use_amp else 'f32'}"
          f", kernels vs plain; flash {','.join(ran)}): " + " ".join(line),
          flush=True)


def moe_bound(gs, c, k, n, w_bytes, scale_rows=0):
    """Bound of one grouped GEMM: the weights of experts with rows (and
    their scale rows) read once, the real x rows read and the whole out
    written once in bf16; 2 x real rows x K x N operations at the bf16
    rate."""
    live = gs.clamp(0, c)
    rows, experts = int(live.sum()), int((live > 0).sum())
    nbytes = experts * (k * n * w_bytes + scale_rows * n * 4) \
        + rows * k * 2 + gs.numel() * c * n * 2 + gs.numel() * 4
    return roofline(nbytes, 2 * rows * k * n, BF16_FLOPS)


def masked_rows(x, gs):
    """``x [E*C, K]`` as ``[E, C, K]`` with rows past each expert's size
    zeroed (the library yardstick's input)."""
    import torch
    e = gs.numel()
    c = x.shape[0] // e
    keep = torch.arange(c, device=x.device)[None, :] < gs.clamp(0, c)[:, None]
    return (x.reshape(e, c, -1) * keep[..., None]).to(x.dtype)


def grouped_case(label, kind, x, w, gs, scales=None, w_lib=None,
                 timed=True):
    """One grouped GEMM launch (``kind`` "float" or "q8") against its
    plain version, with the instance it ran; with ``timed``, its time, the
    plain version's, the library's (``torch.bmm`` on the masked rows
    against ``w_lib``, the bf16 weight) and the bound. Returns the
    numbers."""
    import torch
    from paddle_tpu_torch.ops import grouped_gemm as GG
    e, k, n = w.shape
    c = x.shape[0] // e
    if kind == "q8":
        def run():
            return GG._launch_q8(x, w, scales, gs, WEIGHT_BLOCK)

        def plain():
            return GG.grouped_gemm_q8_ref(x, w, scales, gs, WEIGHT_BLOCK)
        bound_ms, bound_by = moe_bound(gs, c, k, n, 1, k // WEIGHT_BLOCK)
    else:
        def run():
            return GG._launch_float(x, w, gs)

        def plain():
            return GG.grouped_gemm_ref(x, w, gs)
        bound_ms, bound_by = moe_bound(gs, c, k, n, 2)
    before = dict(GG.instance_launches)
    y, ref = run(), plain()
    torch.cuda.synchronize()
    ran = [i for i, n_ in GG.instance_launches.items() if n_ > before[i]]
    err = check_close(f"{label}: out (row, column)", y, ref)
    out = dict(max_abs_err=err, instance=ran[0])
    line = f"moe kernel check ({label}): E={e} C={c} K={k} N={n} " \
        f"gs={gs.tolist()} instance={ran[0]} out_err={err:.3e}"
    if timed:
        xm = masked_rows(x, gs)
        out.update(ms=time_ms(run), device_ms=device_ms(run),
                   plain_ms=time_ms(plain, iters=3, warmup=1),
                   library_ms=time_ms(lambda: torch.bmm(xm, w_lib)),
                   library_device_ms=device_ms(lambda: torch.bmm(xm, w_lib)),
                   bound_ms=bound_ms, bound_by=bound_by)
        line += (f" ms={out['ms']:.4f} device_ms={out['device_ms']:.4f} "
                 f"plain_ms={out['plain_ms']:.3f} library_ms="
                 f"{out['library_ms']:.4f} library_device_ms="
                 f"{out['library_device_ms']:.4f} bound_ms="
                 f"{bound_ms:.5f} ({bound_by})")
    print(line, flush=True)
    return out


def dequant_case(label, x, q, scales, w_lib, block=WEIGHT_BLOCK):
    """The dequant matmul kernel against its plain version on ``x [M,
    K]``, timed (CUDA events, which include the wrapper's host time
    between launches at these sizes, and the profiler's device time),
    with ``F.linear`` on the 16-bit weight ``w_lib [N, K]`` as the
    library yardstick; prints the instance that ran. ``block`` is the
    int8 block (phase 3c's Mixtral shapes use the format's default; a
    C6 point of GEMM_DOMAIN its own)."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.quant import kernels as QK
    (m, k), n = x.shape, q.shape[1]
    before = dict(QK.instance_launches)
    y = QK._launch(x, q, scales, block)
    ran = [i for i, c in QK.instance_launches.items() if c > before[i]]
    ref = QK.dequant_matmul_ref(x, q, scales, block)
    torch.cuda.synchronize()
    err = check_close(f"{label}: out (row, column)", y, ref)
    nbytes = k * n + -(-k // block) * n * 4 + m * k * 2 + m * n * 2
    bound_ms, bound_by = roofline(nbytes, 2 * m * k * n, BF16_FLOPS)

    def run():
        return QK._launch(x, q, scales, block)

    def lib():
        return F.linear(x, w_lib)
    out = dict(max_abs_err=err, ms=time_ms(run), device_ms=device_ms(run),
               plain_ms=time_ms(lambda: QK.dequant_matmul_ref(
                   x, q, scales, block), iters=5, warmup=1),
               library_ms=time_ms(lib), library_device_ms=device_ms(lib),
               bound_ms=bound_ms, bound_by=bound_by, instance=ran[0])
    print(f"dequant kernel check ({label}): M={m} K={k} N={n} B={block} "
          f"{x.dtype} instance={ran[0]} out_err={err:.3e} ms={out['ms']:.4f}"
          f" device_ms={out['device_ms']:.4f} plain_ms={out['plain_ms']:.3f}"
          f" library_ms={out['library_ms']:.4f} library_device_ms="
          f"{out['library_device_ms']:.4f} bound_ms={bound_ms:.5f} "
          f"({bound_by})", flush=True)
    return out


def check_dequant_rows(x, q, scales, label):
    """Rows 0, 5 and 37 of ``x [64, K]`` through the dequant matmul alone,
    then among the first 8 and all 64 rows: bitwise equal."""
    import torch
    from paddle_tpu_torch.quant import kernels as QK
    alone = {i: QK._launch(x[i:i + 1], q, scales, WEIGHT_BLOCK)[0]
             for i in (0, 5, 37)}
    for t in MOE_TOKENS:
        packed = QK._launch(x[:t], q, scales, WEIGHT_BLOCK)
        for i, y in alone.items():
            if i < t and not torch.equal(y, packed[i]):
                fail(f"dequant {label}: row {i} alone differs from the same "
                     f"row among {t - 1} others")
    print(f"dequant row check ({label}): rows 0, 5 and 37 alone == among 7 "
          "and 63 others, bitwise", flush=True)


def check_packing(mlp, x, label):
    """Tokens 0, 5 and 37 of ``x [64, D]`` through ``mlp`` alone, and
    packed in the first 8 (a decode-only dispatch) and in all 64 (a full
    mixed one): bitwise equal outputs."""
    import torch
    with torch.no_grad():
        alone = {i: mlp(x[i:i + 1])[0] for i in (0, 5, 37)}
        for t in MOE_TOKENS:
            packed = mlp(x[:t])
            for i, y in alone.items():
                if i < t and not torch.equal(y, packed[i]):
                    fail(f"{label} MoE FFN: token {i} alone differs from "
                         f"the same token packed among {t - 1} others")
    print(f"moe packing check ({label}): tokens 0, 5 and 37 alone == packed "
          "among 7 and 63 others, bitwise", flush=True)


def check_moe_kernels(dev):
    """Phase 3c: the grouped GEMMs (bf16 and int8 weights, the bf16 one's
    dx too) and the dequant matmul against their plain versions at
    Mixtral-8x7B serving shapes, on the weights of one Mixtral-width
    ``LlamaMoEMLP`` and the rows its router gives; the packing check.
    Returns the three kernels' JSON entries (without ``launches``),
    their times those of the full mixed dispatch (64 tokens; gate/up
    shape for the grouped GEMMs, q/o shape for the dequant matmul)."""
    import torch
    from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaMoEMLP,
                                               router_logits)
    from paddle_tpu_torch.ops import grouped_gemm as GG
    from paddle_tpu_torch.quant.format import dequant_blocks, quantize_weight
    cfg = LlamaConfig(**MIXTRAL)
    d, f = cfg.hidden_size, cfg.intermediate_size
    bf = torch.bfloat16
    g = torch.Generator(dev).manual_seed(5)
    mlp = LlamaMoEMLP(cfg, device=dev, dtype=bf)
    mlp.reset_parameters(cfg.initializer_range, g)
    xs = {t: torch.randn(t, d, device=dev, dtype=bf, generator=g)
          for t in MOE_TOKENS}
    hs = {t: torch.randn(8 * t, f, device=dev, dtype=bf, generator=g)
          for t in MOE_TOKENS}
    routed = {}
    for t in MOE_TOKENS:
        slot, *_, gs = mlp.route(xs[t])
        routed[t] = (xs[t][slot.clamp_min(0)], gs)
    edge = {"empty experts": torch.tensor([3, 0, 5, 0, 2, 1, 4, 1],
                                          device=dev),
            "gs > C": torch.tensor([12, 8, 0, 9, 1, 0, 30, 2], device=dev)}
    res = {"float": {}, "q8": {}}

    def shapes(kind, wu, wd, su=None, sd=None, lu=None, ld=None):
        errs = []
        for t in MOE_TOKENS:
            xg, gs = routed[t]
            for name, x, w, s, lib in (("gate/up", xg, wu, su, lu),
                                       ("down", hs[t], wd, sd, ld)):
                r = grouped_case(f"{kind} {name} T={t}", kind, x, w, gs, s,
                                 lib)
                res[kind][(name, t)] = r
                errs.append(r["max_abs_err"])
        for label, gs in edge.items():
            r = grouped_case(f"{kind} gate/up T=8 {label}", kind,
                             routed[8][0], wu, gs, su, timed=False)
            errs.append(r["max_abs_err"])
        return max(errs)

    err_f = shapes("float", mlp.gate_proj.detach(), mlp.down_proj.detach(),
                   lu=mlp.gate_proj.detach(), ld=mlp.down_proj.detach())
    # dx through the Function's backward (the kernel on w transposed,
    # read in place), dw the plain masked product by construction
    xg, gs = routed[64]
    xg = xg.detach().requires_grad_()
    w = mlp.gate_proj.detach().clone().requires_grad_()
    gy = torch.randn(xg.shape[0], f, device=dev, dtype=bf, generator=g)
    with torch.enable_grad():
        GG.grouped_gemm(xg, w, gs).backward(gy)
    wt = w.detach().transpose(1, 2)
    dx_ref = GG.grouped_gemm_ref(gy, wt, gs)
    torch.cuda.synchronize()
    err_dx = check_close("float dx T=64: (row, column)", xg.grad, dx_ref)
    if not torch.equal(w.grad, GG.grouped_gemm_dw(xg.detach(), gy, gs, bf)):
        fail("grouped GEMM dw differs from the plain masked product")
    dx_ms = time_ms(lambda: GG._launch_float(gy, wt, gs))
    dx_dev = device_ms(lambda: GG._launch_float(gy, wt, gs))
    gm = masked_rows(gy, gs)
    dx_lib = device_ms(lambda: torch.bmm(gm, wt))
    dx_bound, dx_by = moe_bound(gs, 64, f, d, 2)
    print(f"moe kernel check (float dx T=64): out_err={err_dx:.3e} "
          f"dw_bitwise=True ms={dx_ms:.4f} device_ms={dx_dev:.4f} "
          f"library_device_ms={dx_lib:.4f} bound_ms={dx_bound:.5f} "
          f"({dx_by})", flush=True)
    del gm
    del xg, w, gy, wt, dx_ref
    check_packing(mlp.eval(), xs[64], "bf16")
    # what the router's fixed order costs against one library product
    for t in MOE_TOKENS:
        x2d = xs[t].float()
        fixed = time_ms(lambda: router_logits(x2d, mlp.gate))
        lib = time_ms(lambda: (x2d.double() @ mlp.gate.double()).float())
        print(f"moe router (T={t}): fixed-order ms={fixed:.4f} library f64 "
              f"product ms={lib:.4f}", flush=True)

    mlp.quantize_weights(WEIGHT_BLOCK)
    lib_u = dequant_blocks(mlp.gate_proj, mlp.gate_proj_scale,
                          WEIGHT_BLOCK).to(bf)
    lib_d = dequant_blocks(mlp.down_proj, mlp.down_proj_scale,
                          WEIGHT_BLOCK).to(bf)
    err_q = shapes("q8", mlp.gate_proj, mlp.down_proj, mlp.gate_proj_scale,
                   mlp.down_proj_scale, lib_u, lib_d)
    del lib_u, lib_d
    check_packing(mlp, xs[64], "int8")

    dq, err_dq = {}, 0.0
    for n in (4096, 1024):            # q and o; k and v
        w = torch.randn(d, n, device=dev, generator=g) * 0.02
        q, s = quantize_weight(w, WEIGHT_BLOCK)
        w_lib = dequant_blocks(q, s, WEIGHT_BLOCK).t().contiguous().to(bf)
        for t in MOE_TOKENS:
            dq[(n, t)] = dequant_case(f"N={n} T={t}", xs[t], q, s, w_lib)
            err_dq = max(err_dq, dq[(n, t)]["max_abs_err"])
        check_dequant_rows(xs[64], q, s, f"N={n}")
    timing = ("ms", "device_ms", "plain_ms", "library_ms",
              "library_device_ms", "bound_ms", "bound_by")
    return [dict(name="grouped_gemm", route="cuda", source=GG_SOURCE,
                 replaces="paddle_tpu/ops/grouped_gemm.py:175",
                 max_abs_err=max(err_f, err_dx),
                 **{k: res["float"][("gate/up", 64)][k] for k in timing}),
            dict(name="grouped_gemm_q8", route="cuda", source=GG_SOURCE,
                 replaces="paddle_tpu/ops/grouped_gemm.py:405",
                 max_abs_err=err_q,
                 **{k: res["q8"][("gate/up", 64)][k] for k in timing}),
            dict(name="dequant_matmul", route="cuda",
                 source="paddle_tpu_torch/csrc/dequant_matmul.cu",
                 replaces="paddle_tpu/quant/kernels.py:132",
                 max_abs_err=err_dq,
                 **{k: dq[(4096, 64)][k] for k in timing},
                 decode_t8={k: dq[(4096, 8)][k] for k in timing})]


# phase 3c: the GEMM family at points of the reference's domain past the
# serving shapes: label -> (kernel, x dtype, E, C (M for the dequant
# matmul), K, N, block, timed). Each runs the instance ``gemm_instance``
# names: the general one (C6), but for the grouped GEMMs' f16 points,
# which their cluster instances take (CLUSTER_POINTS). A timed point goes
# through dequant_case or grouped_case (a "q8" one at WEIGHT_BLOCK, the
# block grouped_case takes).
CLUSTER_POINTS = ("#7 f16 x", "#6 f16 x", "#6 f16 x Mixtral gate/up")
GEMM_DOMAIN = {
    "#7 f16 x": ("q8", "float16", 8, 8, 4096, 1024, WEIGHT_BLOCK, True),
    "#6 f16 x Mixtral gate/up": ("float", "float16", 8, 8, 4096, 14336, None,
                                 True),
    "#8 B=24": ("dq", "bfloat16", 1, 8, 4096, 4096, 24, True),
    "#8 B=8": ("dq", "bfloat16", 1, 9, 96, 64, 8, False),
    "#8 N=24 K=40": ("dq", "bfloat16", 1, 70, 40, 24, 40, False),
    "#8 f32 K=37 N=29": ("dq", "float32", 1, 3, 37, 29, 16, False),
    "#6 f16 x": ("float", "float16", 3, 8, 64, 48, None, False),
    "#6 K=40 N=20": ("float", "bfloat16", 3, 8, 40, 20, None, False),
    "#7 B=24": ("q8", "bfloat16", 3, 8, 96, 64, 24, False),
    "#7 N=24 B=8": ("q8", "bfloat16", 3, 8, 40, 24, 8, False),
    "#7 f32 K=37 N=29": ("q8", "float32", 3, 8, 37, 29, 16, False),
}


def check_gemm_domain(dev):
    """Phase 3c, C6: the grouped GEMMs and the dequant matmul at
    GEMM_DOMAIN's points (f16 x, blocks of 8, 24 and 40, N 24, K and N
    off multiples of 8): each launches the instance ``gemm_instance``
    names (the general one but at CLUSTER_POINTS) and stays within phase 3's
    bound of its plain version; the timed points also get phase 3c's
    times, bound and library time. Returns the largest error of each
    kernel by its JSON name."""
    import torch
    from paddle_tpu_torch.ops import grouped_gemm as GG
    from paddle_tpu_torch.ops._tile_gemm import gemm_instance
    from paddle_tpu_torch.quant import kernels as QK
    from paddle_tpu_torch.quant.format import dequant_blocks, quantize_weight
    g = torch.Generator(dev).manual_seed(7)
    errs = {"grouped_gemm": 0.0, "grouped_gemm_q8": 0.0,
            "dequant_matmul": 0.0}
    for label, (kind, dtype, e, c, k, n, block, timed) in GEMM_DOMAIN.items():
        dt = getattr(torch, dtype)
        w = torch.randn(e, k, n, device=dev, generator=g) * 0.05
        x = torch.randn(e * c, k, device=dev, generator=g).to(dt)
        gs = torch.tensor([c, 0, c + 2, 1, c - 1, 3, 0, c][:e],
                          dtype=torch.int32, device=dev)
        if kind == "dq":
            name, counts = "dequant_matmul", QK.instance_launches
            q, s = quantize_weight(w[0], block)

            def run():
                return QK._launch(x, q, s, block)

            def plain():
                return QK.dequant_matmul_ref(x, q, s, block)
        elif kind == "q8":
            name, counts = "grouped_gemm_q8", GG.instance_launches
            q, s = quantize_weight(w, block)

            def run():
                return GG._launch_q8(x, q, s, gs, block)

            def plain():
                return GG.grouped_gemm_q8_ref(x, q, s, gs, block)
        else:
            name, counts = "grouped_gemm", GG.instance_launches
            wt = w.to(dt)

            def run():
                return GG._launch_float(x, wt, gs)

            def plain():
                return GG.grouped_gemm_ref(x, wt, gs)
        inst = gemm_instance(name, dt, k, n, block and min(block, k))
        key = f"{name}.{inst}"
        before = counts[key]
        tag = f"gemm domain {label}"
        if timed and kind == "dq":
            lib = dequant_blocks(q, s, block).t().contiguous().to(dt)
            err = dequant_case(tag, x, q, s, lib, block)["max_abs_err"]
        elif timed and kind == "float":
            err = grouped_case(tag, kind, x, wt, gs, w_lib=wt)["max_abs_err"]
        elif timed:
            lib = dequant_blocks(q, s, block).to(dt)
            err = grouped_case(tag, kind, x, q, gs, s, lib)["max_abs_err"]
        else:
            y, ref = run(), plain()
            torch.cuda.synchronize()
            err = check_close(tag, y, ref)
            print(f"gemm domain check ({label}): E={e} C={c} K={k} N={n} "
                  f"B={block} {dtype} instance={key} out_err={err:.3e}",
                  flush=True)
        want = "cluster" if label in CLUSTER_POINTS else "general"
        if inst != want or counts[key] == before:
            fail(f"{tag}: ran {key}, not the {want} instance")
        errs[name] = max(errs[name], err)
    return errs


def mixtral_int8(dev):
    """Mixtral-8x7B at full width and depth with int8 weights: a 0-layer
    model on the card, then each of the 32 layers made on ``meta``,
    moved to the card, initialised from one seeded generator and
    quantized before the next exists (a bf16 layer is ~2.9 GB; the whole
    bf16 model, 93 GB, would not fit)."""
    import torch
    from torch import nn
    from paddle_tpu_torch.models.llama import (LlamaConfig,
                                               LlamaDecoderLayer,
                                               LlamaForCausalLM, LlamaMoEMLP,
                                               RMSNorm)
    from paddle_tpu_torch.quant import quantize_model
    cfg = LlamaConfig(**MIXTRAL)
    std = cfg.initializer_range
    gen = torch.Generator(dev).manual_seed(0)
    model = LlamaForCausalLM(dataclasses.replace(cfg, num_hidden_layers=0),
                             device=dev, dtype=torch.bfloat16, generator=gen)
    with torch.no_grad():
        for _ in range(cfg.num_hidden_layers):
            layer = LlamaDecoderLayer(cfg, device="meta",
                                      dtype=torch.bfloat16)
            layer.to_empty(device=dev)
            for mod in layer.modules():
                if isinstance(mod, nn.Linear):
                    mod.weight.normal_(0.0, std, generator=gen)
                elif isinstance(mod, RMSNorm):
                    mod.weight.fill_(1.0)
                elif isinstance(mod, LlamaMoEMLP):
                    mod.reset_parameters(std, gen)
            model.model.layers.append(quantize_model(layer))
    model.config = model.model.config = cfg
    return model.eval()


@contextlib.contextmanager
def plain_serving_paths():
    """Route the grouped GEMMs, the dequant matmul and the no-cache
    forward's attention to their plain versions (the token check)."""
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.ops import grouped_gemm as GG
    from paddle_tpu_torch.quant import kernels as QK
    saved = (GG._launch_float, GG._launch_q8, QK._launch,
             llama.causal_attention)
    GG._launch_float, GG._launch_q8 = GG.grouped_gemm_ref, \
        GG.grouped_gemm_q8_ref
    QK._launch = QK.dequant_matmul_ref
    llama.causal_attention = llama.plain_attention
    try:
        yield
    finally:
        (GG._launch_float, GG._launch_q8, QK._launch,
         llama.causal_attention) = saved


def kernel_launches():
    """The launch counters of the serving path's kernels."""
    from paddle_tpu_torch.ops import grouped_gemm as GG
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    from paddle_tpu_torch.quant import kernels as QK
    return dict(**{f"attention {k}": n for k, n in rpa.launches.items()},
                dequant_matmul=QK.launches, **GG.launches)


@contextlib.contextmanager
def recorded_routes(engine, layers):
    """Record, for every dispatch of ``engine``, its rows and each MoE
    layer's expert choices; yields ``choices(req, n)``, the ``[L, n, k]``
    experts the engine chose at positions ``0..n-1`` of ``req``."""
    from paddle_tpu_torch.models.llama import LlamaMoEMLP
    route, dispatch = LlamaMoEMLP.route, engine._dispatch_rows
    picks, rows_of = [], []

    def recording_route(self, x2d):
        out = route(self, x2d)
        picks.append(out[1])
        return out

    def recording_dispatch(rows):
        rows_of.append([(r, start, n) for r, _, start, n, _, _ in rows])
        return dispatch(rows)

    def choices(req, n):
        import torch
        out = torch.full((layers, n, picks[0].shape[1]), -1,
                         dtype=torch.long, device=picks[0].device)
        for d, rows in enumerate(rows_of):
            t = 0
            for r, start, m in rows:
                if r is req:
                    for li in range(layers):
                        out[li, start:start + m] = \
                            picks[d * layers + li][t:t + m]
                t += m
        if bool((out < 0).any()):
            fail("a position of a served request was never routed")
        return out
    LlamaMoEMLP.route = recording_route
    engine._dispatch_rows = recording_dispatch
    try:
        yield choices
    finally:
        LlamaMoEMLP.route = route
        del engine._dispatch_rows


@contextlib.contextmanager
def replayed_routes(model, stats):
    """Make every ``LlamaMoEMLP`` of ``model`` take the experts in
    ``stats["choices"]`` (``[L, n, k]``, set per forward) instead of its
    own top-k, with the weights its own softmax gives them; record in
    ``stats`` how far each replayed choice is from the plain router's
    own top-k (router logit of its k-th choice minus the smallest
    replayed one's, per route) and, per layer, how many routes there
    were and how many differ."""
    import torch
    from paddle_tpu_torch.incubate.moe import top_k_routing
    from paddle_tpu_torch.models.llama import LlamaMoEMLP, router_logits
    layer_of = {id(layer.mlp): i for i, layer in enumerate(model.model.layers)}
    route = LlamaMoEMLP.route

    def replay(self, x2d):
        n, e, k = x2d.shape[0], self.num_experts, self.top_k
        chosen = stats["choices"][layer_of[id(self)]]
        logits = router_logits(x2d, self.gate)
        probs = torch.softmax(logits, dim=-1)
        keep = torch.zeros_like(logits, dtype=torch.bool).scatter_(
            1, chosen, True)
        out = list(top_k_routing(logits.masked_fill(~keep, float("-inf")),
                                 k, n))
        picked = probs.gather(1, out[1])
        out[4] = picked / (picked.sum(dim=-1, keepdim=True) + 1e-9)
        own = torch.sort(logits, dim=-1, descending=True, stable=True)
        deficit = own.values[:, k - 1] - logits.gather(1, out[1]).min(-1).values
        li = layer_of[id(self)]
        stats["deficits"][li].append(deficit)
        stats["flips"][li] += int((own.indices[:, :k].sort(dim=-1).values
                                   != out[1].sort(dim=-1).values).any(-1).sum())
        stats["routes"][li] += n
        gs = ((out[1].reshape(-1, 1) == torch.arange(e, device=x2d.device))
              & out[3].reshape(-1, 1)).sum(dim=0, dtype=torch.int32)
        return tuple(out) + (gs,)
    LlamaMoEMLP.route = replay
    try:
        yield
    finally:
        LlamaMoEMLP.route = route


def serve_moe(dev, label, model, weight_dtype, per_layer):
    """Phases 6 and 7: serve phase 4's prompts through
    ``LlamaServingEngine(max_batch=8, page_size=16, weight_dtype=...)``
    with every kernel launch counted (``per_layer``: launches of each
    kernel per layer per dispatch; the attention kernel's two always) and
    no plain version called; then every served token against the
    model's own forward through the plain versions.

    Routing is discontinuous: two paths whose sums round differently
    pick different experts where the router's top-k is a near-tie, and
    on random weights at full depth those flips cascade (the first chip
    run matched 36/256 tokens this way). So the plain forward replays
    the experts the engine chose at every (position, layer), with the
    weights its own router gives them. The paths drift apart with depth
    as the dense model's do (phase 4's logits), and the replayed choices
    drift from the plain router's own top-k with them: the line prints
    how often and how far, per quarter of the layers. At layer 0 the
    two paths' router inputs differ only by the rounding of the
    attention and projection kernels, so there every replayed choice
    must be within ROUTE_TOL router logits of the plain top-k: an
    engine that routed wrongly would fail there, or in the token check.
    Returns the launches."""
    import torch
    from paddle_tpu_torch.inference import LlamaServingEngine, Request
    cfg = model.config
    layers = cfg.num_hidden_layers
    engine = LlamaServingEngine(model, max_batch=8, page_size=16,
                                weight_dtype=weight_dtype)
    prompts = serving_prompts(cfg.vocab_size)
    engine.generate([prompts[0][:16]], max_new_tokens=2)   # warm-up
    finite, steps = [], []
    hook = model.lm_head.register_forward_hook(
        lambda mod, inp, out: finite.append(torch.isfinite(out).all()))
    forward = engine._mixed_forward

    def timed(*a):
        t0 = time.perf_counter()
        out = forward(*a)
        torch.cuda.synchronize()
        steps.append((a[-1], time.perf_counter() - t0))
        return out
    engine._mixed_forward = timed
    reqs = [Request(p, max_new_tokens=NEW) for p in prompts]
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    d0 = engine._dispatch_count
    with count_calls(serving_plain_versions()) as plain_calls, \
            recorded_routes(engine, layers) as choices:
        t0 = time.perf_counter()
        outs = engine.generate(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel_launches()
        replay = [choices(r, len(p) + NEW - 1) for r, p in zip(reqs, prompts)]
    dispatches = engine._dispatch_count - d0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del engine._mixed_forward
    hook.remove()
    if plain_calls:
        fail(f"{label}: plain versions ran on the card: "
             f"{sorted(set(plain_calls))}")
    want = {k: per_layer.get(k, 0) * layers * dispatches for k in launches}
    want["attention fused_rope"] = 2 * layers * dispatches
    if launches != want or not dispatches:
        fail(f"{label}: kernel launches {launches} != {want} "
             f"({dispatches} dispatches)")
    if not all(bool(f) for f in finite):
        fail(f"{label}: non-finite logits in the serving run")
    for o in outs:
        if len(o) != NEW or not all(0 <= t < cfg.vocab_size for t in o):
            fail(f"{label}: bad output {o}")
    gaps = []
    stats = dict(deficits=[[] for _ in range(layers)], flips=[0] * layers,
                 routes=[0] * layers)
    with plain_serving_paths(), replayed_routes(model, stats):
        before = kernel_launches()
        for p, o, chosen in zip(prompts, outs, replay):
            stats["choices"] = chosen
            ids = torch.tensor([p + o[:-1]], device=dev)
            with torch.no_grad():
                lg = model(ids)[0, len(p) - 1:].float()
            picked = lg.gather(1, torch.tensor(o, device=dev)[:, None])[:, 0]
            gaps.append(lg.max(dim=1).values - picked)
        torch.cuda.synchronize()
        if kernel_launches() != before:
            fail(f"{label}: the plain check launched a kernel")
    gaps = torch.cat(gaps)
    exact, worst = int((gaps == 0).sum()), float(gaps.max())
    deficits = [float(torch.cat(d).max()) for d in stats["deficits"]]
    quarter = max(1, layers // 4)
    flips = [f"{sum(stats['flips'][i:i + quarter])}/"
             f"{sum(stats['routes'][i:i + quarter])}"
             for i in range(0, layers, quarter)]
    worst_route = [round(max(deficits[i:i + quarter]), 4)
                   for i in range(0, layers, quarter)]
    n_tok = len(prompts) * NEW
    ttft = sorted(r.ttft for r in reqs)
    dec = [s for qb, s in steps if qb == 1]
    mixed = [s for qb, s in steps if qb != 1]
    print(f"serve {label}: layers={layers} requests={len(prompts)} "
          f"prompt_tokens={sum(map(len, prompts))} new_tokens={n_tok} "
          f"dispatches={dispatches} launches={launches} wall_s={wall:.3f} "
          f"tokens_per_s={n_tok / wall:.1f} ttft_ms_p50="
          f"{1e3 * ttft[len(ttft) // 2]:.1f} ttft_ms_max={1e3 * ttft[-1]:.1f}"
          f" decode_dispatch_ms={1e3 * sum(dec) / max(len(dec), 1):.2f} "
          f"(n={len(dec)}) mixed_dispatch_ms="
          f"{1e3 * sum(mixed) / max(len(mixed), 1):.2f} (n={len(mixed)}) "
          f"peak_mem_gb={peak:.2f} plain_forward_exact={exact}/{n_tok} "
          f"worst_gap={worst:.4f} gap_p90={float(gaps.quantile(0.9)):.4f} "
          f"route_flips_by_layer_quarter={flips} route_deficit_max_by_"
          f"layer_quarter={worst_route} layer0_route_flips="
          f"{stats['flips'][0]}/{stats['routes'][0]} layer0_route_deficit="
          f"{deficits[0]:.4f}", flush=True)
    if deficits[0] > ROUTE_TOL:
        fail(f"{label}: at layer 0 an expert the engine chose is "
             f"{deficits[0]:.3f} router logits below the plain router's "
             f"top-{cfg.moe_top_k} (tol {ROUTE_TOL})")
    if exact < EXACT_FLOOR * n_tok:
        fail(f"{label}: only {exact}/{n_tok} served tokens are the plain "
             f"forward's argmax (floor {EXACT_FLOOR})")
    if worst > TIE_TOL:
        fail(f"{label}: served token {worst:.3f} below the plain forward's "
             "argmax")
    return launches


def serve_mixtral_int8(dev):
    """Phase 6: Mixtral-8x7B, int8 weights, 32 layers, one card."""
    import torch
    from paddle_tpu_torch.quant import serving_weight_bytes
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = mixtral_int8(dev)
    torch.cuda.synchronize()
    actual, baseline, _ = serving_weight_bytes(model)
    print(f"model: mixtral_8x7b int8 layers={model.config.num_hidden_layers}"
          f" init_s={time.perf_counter() - t0:.1f} weight_bytes="
          f"{actual} bf16_baseline_bytes={baseline} build_peak_mem_gb="
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f}", flush=True)
    return serve_moe(dev, "mixtral int8", model, "int8",
                     {"dequant_matmul": 4, "grouped_gemm_q8": 3})


def serve_mixtral_bf16(dev):
    """Phase 7: the bf16 MoE FFN, Mixtral-8x7B width, 4 layers."""
    import torch
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    cfg = dataclasses.replace(LlamaConfig(**MIXTRAL),
                              num_hidden_layers=FLOAT_MOE_LAYERS)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                             generator=torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    print(f"model: mixtral_8x7b bf16 layers={FLOAT_MOE_LAYERS} params="
          f"{model.num_params()} init_s={time.perf_counter() - t0:.1f}",
          flush=True)
    return serve_moe(dev, "mixtral bf16", model.eval(), None,
                     {"grouped_gemm": 3})


# ----------------------------------------------------------------------
# the sampler: phases 3g, 11, 12
# ----------------------------------------------------------------------

def sampler_rows(dev, n, v, seed):
    """``n`` rows of the sampler's per-row arrays at vocabulary ``v``,
    greedy, top-k 50, top-p 0.9 and constrained rows in turn, seeded
    logits ``[n, v]`` (std 3) on the card. Returns (logits, arrays)."""
    import torch
    g = torch.Generator(dev).manual_seed(seed)
    logits = torch.randn((n, v), device=dev, generator=g) * 3
    kind = torch.arange(n, device=dev) % 4
    temps = torch.where(kind == 0, 0.0, torch.where(kind == 2, 0.8, 1.0))
    top_ps = torch.where(kind == 2, 0.9, 1.0)
    top_ks = torch.where(kind == 1, 50, 0).int()
    seeds = torch.randint(0, 2 ** 31, (n,), device=dev, generator=g).int()
    positions = torch.randint(0, 8192, (n,), device=dev, generator=g).int()
    slot_ids = torch.full((n, 8), -1, dtype=torch.int32, device=dev)
    slot_ids[kind == 3] = torch.tensor(ALLOWED, dtype=torch.int32,
                                       device=dev)
    slot_vals = torch.zeros((n, 8), device=dev)
    cmodes = (kind == 3).int()
    return logits, (temps, top_ps, top_ks, seeds, positions, slot_ids,
                    slot_vals, cmodes)


def sampler_bound(n, v):
    """(ms, "bytes" | "operations"): the scores read once (and the per-row
    operands) against GUMBEL_INT_OPS integer operations an element."""
    nbytes = n * v * 4 + n * (4 + 4 + 8 + 4 + 8)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = GUMBEL_INT_OPS * n * v / INT32_OPS * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes \
        else (by_bytes, "bytes")


def check_sampler(dev):
    """Phase 3g: ``gumbel_argmax`` / ``gumbel_noise`` against the plain
    version at the sampler's shapes. Returns the JSON entry (without
    ``launches``), timed at 8 rows of Llama-3's vocabulary."""
    import torch
    from paddle_tpu_torch.inference.sampling import (biased_logits,
                                                     scaled_scores)
    from paddle_tpu_torch.ops import sampling as SM
    entry, g_err = None, 0.0
    for name, v in SAMPLER_VOCABS.items():
        for n in SAMPLER_ROWS:
            label = f"gumbel {name} n={n}"
            logits, arrays = sampler_rows(dev, n, v, seed=n + v)
            temps, top_ps, top_ks, seeds, positions, slot_ids, slot_vals, \
                cmodes = arrays
            ls, thr = scaled_scores(
                biased_logits(logits, slot_ids, slot_vals, cmodes), temps,
                top_ps, top_ks)
            bases = torch.zeros(n, dtype=torch.int64, device=dev)
            args = (ls, seeds, positions, bases, thr)
            with count_calls([(SM, "gumbel_argmax_ref"),
                              (SM, "gumbel_noise_ref")]) as plain_calls:
                l0 = dict(SM.launches)
                bits, u, g = SM.gumbel_noise(seeds, positions, bases, v)
                got = SM.gumbel_argmax(*args)
                torch.cuda.synchronize()
            if plain_calls or SM.launches["gumbel_noise"] != \
                    l0["gumbel_noise"] + 1 or SM.launches["gumbel_argmax"] \
                    != l0["gumbel_argmax"] + 1:
                fail(f"{label}: launches {SM.launches} from {l0}, plain "
                     f"calls {plain_calls}")
            rb, ru, rg = SM.gumbel_noise_ref(seeds, positions, bases, v)
            if not torch.equal(bits, rb) or not torch.equal(
                    u.view(torch.int32), ru.view(torch.int32)):
                fail(f"{label}: bits or uniforms differ from the plain "
                     "version's")
            rel = float(((g - rg).abs() / rg.abs().clamp_min(1.0)).max())
            g_err = max(g_err, float((g - rg).abs().max()))
            if rel > SM.GUMBEL_REL:
                fail(f"{label}: g off by {rel:.3e} (tol {SM.GUMBEL_REL})")
            z = SM.perturbed_scores(*args)
            want = z.argmax(dim=-1)
            tol = 2 * SM.GUMBEL_REL * 17.0
            for i in torch.nonzero(got != want)[:, 0].tolist():
                margin = float(z[i, want[i]] - z[i, got[i]])
                print(f"{label}: row {i} token {int(got[i])} vs plain "
                      f"{int(want[i])}, margin {margin:.3e}", flush=True)
                if not 0.0 <= margin <= tol + 1e-5 * float(z[i, want[i]]
                                                           .abs()):
                    fail(f"{label}: row {i} differs beyond the tolerance")
            if not all(int(t) in ALLOWED for t in got[cmodes == 1]):
                fail(f"{label}: a constrained row left its allowed set")
            ms = time_ms(lambda: SM.gumbel_argmax(*args))
            dev_ms = device_ms(lambda: SM.gumbel_argmax(*args))
            plain_ms = time_ms(lambda: SM.gumbel_argmax_ref(*args), iters=5,
                               warmup=1)
            sort_ms = time_ms(lambda: torch.sort(ls, dim=-1,
                                                 descending=True))
            bound_ms, bound_by = sampler_bound(n, v)
            print(f"kernel check ({label}): rows={n} vocab={v} bits and u "
                  f"bitwise, g_rel_err={rel:.3e} (tol {SM.GUMBEL_REL:.3e}) "
                  f"tokens_equal={int((got == want).sum())}/{n} ms={ms:.4f} "
                  f"device_ms={dev_ms:.4f} plain_ms={plain_ms:.3f} "
                  f"sort_ms={sort_ms:.4f} bound_ms={bound_ms:.5f} "
                  f"({bound_by})", flush=True)
            if entry is None:
                entry = dict(name="gumbel_argmax", route="cuda",
                             source=SM_SOURCE, replaces=SM_REPLACES, ms=ms,
                             device_ms=dev_ms, plain_ms=plain_ms,
                             sort_ms=sort_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=None)
    entry["max_abs_err"] = g_err
    return entry


@contextlib.contextmanager
def sampled_dispatches(engine):
    """Count ``engine``'s dispatches that hold a sampled row and the
    ``gumbel_argmax`` launches and sorts of each: yields a list of
    ``(sampled, launches, sorts)``, one per dispatch."""
    import torch
    from paddle_tpu_torch.ops import sampling as SM
    seen, sorts = [], []
    real_sort, dispatch = torch.sort, engine._dispatch_rows

    def counted_sort(*a, **k):
        sorts.append(1)
        return real_sort(*a, **k)

    def wrapper(rows):
        sampled = any(r.sampling is not None and r.sampling.temperature > 0
                      for r, *_ in rows)
        l0, s0 = SM.launches["gumbel_argmax"], len(sorts)
        out = dispatch(rows)
        seen.append((sampled, SM.launches["gumbel_argmax"] - l0,
                     len(sorts) - s0))
        return out
    torch.sort, engine._dispatch_rows = counted_sort, wrapper
    try:
        yield seen
    finally:
        torch.sort, engine._dispatch_rows = real_sort, dispatch


def sampled_requests(prompts):
    """Phase 11's requests over phase 4's prompts (SAMPLED_ROWS), each
    sampled one with its own fixed seed."""
    from paddle_tpu_torch.inference import Request, SamplingParams
    reqs = []
    for i, (p, kind) in enumerate(zip(prompts, SAMPLED_ROWS)):
        if kind is None:
            sp = None
        elif kind == "forced":
            sp = SamplingParams(temperature=1.0, seed=1000 + i,
                                logit_bias={FORCED_TOKEN: 1e9})
        elif kind == "constrained":
            sp = SamplingParams(temperature=1.0, seed=1000 + i,
                                constraint=lambda a, b: ALLOWED)
        else:
            sp = SamplingParams(seed=1000 + i, **kind)
        reqs.append(Request(p, max_new_tokens=NEW, sampling=sp))
    return reqs


def replay_sampled(engine, model, dev, req, out):
    """Replay one sampled request: the model's plain forward over its
    prompt and tokens, then the plain sampler at each emitted token's
    (seed, position) with the rows the engine packs. Returns (tokens,
    ``(position, margin, replay token's and served token's scaled logit
    over the replay's keep threshold)`` where they differ: a token near a
    top-k or top-p boundary can be kept by one side only)."""
    import torch
    from paddle_tpu_torch.inference.sampling import (biased_logits,
                                                     scaled_scores)
    from paddle_tpu_torch.ops import sampling as SM
    p = list(req.prompt_ids)
    ids = torch.tensor([p + out[:-1]], device=dev)
    with torch.no_grad():
        lg = model(ids)[0, len(p) - 1:].float()
    rows = [(req, req.seq_id, len(p) + j - 1, 1, (0,), True)
            for j in range(len(out))]
    arrays, _ = engine._sample_arrays(rows)
    temps, top_ps, top_ks, seeds, positions, slot_ids, slot_vals, cmodes = \
        [torch.from_numpy(a).to(dev) for a in arrays]
    ls, thr = scaled_scores(biased_logits(lg, slot_ids, slot_vals, cmodes),
                            temps, top_ps, top_ks)
    bases = torch.zeros_like(positions, dtype=torch.int64)
    z = SM.perturbed_scores(ls, seeds, positions, bases, thr)
    toks = z.argmax(dim=-1)
    got = torch.tensor(out, device=dev)
    margins = (z.gather(1, toks[:, None]) - z.gather(1, got[:, None]))[:, 0]
    diff = torch.nonzero(toks != got)[:, 0].tolist()
    return toks.tolist(), [(i, float(margins[i]),
                            float(ls[i, toks[i]] - thr[i]),
                            float(ls[i, got[i]] - thr[i])) for i in diff]


def serve_sampled(dev, greedy_outs, greedy_tps):
    """Phase 11: phase 4's model and prompts with sampled rows (see the
    module docstring). Returns the ``gumbel_argmax`` launches."""
    import torch
    from paddle_tpu_torch.ops import sampling as SM
    cfg, model, engine, prompts = serving_workload(dev)
    runs = []
    for _ in range(2):
        reqs = sampled_requests(prompts)
        with count_calls(serving_plain_versions()
                         + [(SM, "gumbel_argmax_ref")]) as plain_calls, \
                sampled_dispatches(engine) as seen:
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = engine.generate(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        runs.append((reqs, outs, wall, seen, SM.launches["gumbel_argmax"]))
        if plain_calls:
            fail(f"serve sampled: plain versions ran on the card: "
                 f"{sorted(set(plain_calls))}")
    (reqs, outs, wall, seen, launches), second = runs[0], runs[1]
    if second[1] != outs:
        fail("serve sampled: a second run with the same seeds differs")
    for sampled, n_launch, n_sort in seen:
        if (n_launch, n_sort) != ((1, 1) if sampled else (0, 0)):
            fail(f"serve sampled: a dispatch (sampled={sampled}) launched "
                 f"gumbel_argmax {n_launch} times and sorted {n_sort} times")
    n_sampled = sum(s for s, _, _ in seen)
    if launches != n_sampled or not n_sampled:
        fail(f"serve sampled: {launches} launches for {n_sampled} sampled "
             "dispatches")
    kinds = SAMPLED_ROWS
    for i, (kind, o) in enumerate(zip(kinds, outs)):
        if len(o) != NEW or not all(0 <= t < cfg.vocab_size for t in o):
            fail(f"serve sampled: bad output {o}")
        if kind is None and o != greedy_outs[i]:
            fail(f"serve sampled: greedy row {i} differs from phase 4's")
        if kind == "forced" and set(o) != {FORCED_TOKEN}:
            fail(f"serve sampled: forced row {i} gave {sorted(set(o))}")
        if kind == "constrained" and not set(o) <= set(ALLOWED):
            fail(f"serve sampled: constrained row {i} left its set: {o}")
    exact, n_tok, diffs = 0, 0, []
    with plain_serving_paths():
        for i, (r, o) in enumerate(zip(reqs, outs)):
            if kinds[i] is None:
                continue
            toks, margins = replay_sampled(engine, model, dev, r, o)
            exact += sum(a == b for a, b in zip(toks, o))
            n_tok += len(o)
            diffs += [(i,) + m for m in margins]
    for i, pos, margin, over_r, over_s in diffs:
        print(f"serve sampled: row {i} token {pos} differs from the plain "
              f"replay, its margin there {margin:.4f} (over the keep "
              f"threshold: replay's token {over_r:.4f}, served "
              f"{over_s:.4f})", flush=True)
    tps = len(prompts) * NEW / wall
    print(f"serve sampled: requests={len(prompts)} new_tokens="
          f"{len(prompts) * NEW} dispatches={len(seen)} sampled_dispatches="
          f"{n_sampled} gumbel_launches={launches} wall_s={wall:.3f} "
          f"tokens_per_s={tps:.1f} (phase 4 greedy: {greedy_tps:.1f}) "
          f"second_run_wall_s={second[2]:.3f} plain_replay_exact={exact}/"
          f"{n_tok}", flush=True)
    if exact < EXACT_FLOOR * n_tok:
        fail(f"serve sampled: only {exact}/{n_tok} sampled tokens are the "
             f"plain replay's (floor {EXACT_FLOOR})")
    return launches


def generate_prompts(vocab):
    import numpy as np
    rng = np.random.RandomState(12)
    return rng.randint(0, vocab, (GEN_PROMPTS, GEN_LEN)).tolist()


def generate_phase(dev):
    """Phase 12: ``LlamaForCausalLM.generate`` at Llama-3-8B's full width
    and depth (see the module docstring). Returns the ``gumbel_argmax``
    launches."""
    import torch
    from paddle_tpu_torch.inference import LlamaServingEngine
    from paddle_tpu_torch.ops import sampling as SM
    cfg, model = llama_model(dev)
    prompts = generate_prompts(cfg.vocab_size)
    ids = torch.tensor(prompts, device=dev)
    model.generate(ids[:, :16], max_new_tokens=2)            # warm-up
    timed = {}
    for name, kw in (("greedy", {}),
                     ("sampled", dict(do_sample=True, top_k=50, top_p=0.9,
                                      seed=1234))):
        with count_calls([(SM, "gumbel_argmax_ref")]) as plain_calls:
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model.generate(ids, max_new_tokens=GEN_NEW, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = SM.launches["gumbel_argmax"]
        want = GEN_NEW if kw else 0
        if plain_calls or launches != want:
            fail(f"generate {name}: {launches} gumbel_argmax launches "
                 f"(want {want}), plain calls {plain_calls}")
        new = out[:, GEN_LEN:]
        if tuple(out.shape) != (GEN_PROMPTS, GEN_LEN + GEN_NEW) or \
                not bool(((new >= 0) & (new < cfg.vocab_size)).all()):
            fail(f"generate {name}: bad output {tuple(out.shape)}")
        timed[name] = (new.tolist(), wall, launches)
    engine = LlamaServingEngine(model, max_batch=8, page_size=16)
    served = engine.generate(prompts, max_new_tokens=GEN_NEW)
    greedy = timed["greedy"][0]
    same = sum(a == b for o, e in zip(greedy, served) for a, b in zip(o, e))
    gaps = []
    with plain_serving_paths():
        for p, o in zip(prompts, greedy):
            seq = torch.tensor([p + o[:-1]], device=dev)
            with torch.no_grad():
                lg = model(seq)[0, len(p) - 1:].float()
            picked = lg.gather(1, torch.tensor(o, device=dev)[:, None])[:, 0]
            gaps.append(lg.max(dim=1).values - picked)
    gaps = torch.cat(gaps)
    exact, worst = int((gaps == 0).sum()), float(gaps.max())
    n_tok = GEN_PROMPTS * GEN_NEW
    print(f"generate: prompts={GEN_PROMPTS}x{GEN_LEN} new={GEN_NEW} "
          f"greedy_ms_per_step={1e3 * timed['greedy'][1] / GEN_NEW:.2f} "
          f"sampled_ms_per_step={1e3 * timed['sampled'][1] / GEN_NEW:.2f} "
          f"sampled_gumbel_launches={timed['sampled'][2]} "
          f"greedy_equal_to_engine={same}/{n_tok} plain_forward_exact="
          f"{exact}/{n_tok} worst_gap={worst:.4f}", flush=True)
    if exact < EXACT_FLOOR * n_tok or worst > TIE_TOL:
        fail(f"generate: greedy tokens {exact}/{n_tok} the plain forward's "
             f"argmax, worst gap {worst:.3f} (floors {EXACT_FLOOR}, "
             f"{TIE_TOL})")
    return timed["sampled"][2]


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
    for line in flash_registers():
        print(line, flush=True)
    entry, = check_kernels(dev)                     # phase 3: #12
    family = check_kernels(dev, FAMILY)             # phase 3d
    domain_errs = check_kernel_domain(dev)          # phase 3d, widened
    long_errs = check_long_context(dev)             # phase 3f
    for e in [entry] + family:
        key = next(k for k, v in VARIANTS.items() if v[0] == e["name"])
        e["max_abs_err"] = max(e["max_abs_err"], domain_errs[key],
                               long_errs.get(key, 0.0))
    paged = check_paged_kernel(dev)                 # phase 3e: #4
    torch.cuda.empty_cache()
    training_entries = check_flash(dev) + [check_ce(dev)]
    torch.cuda.empty_cache()
    moe_entries = check_moe_kernels(dev)
    gemm_errs = check_gemm_domain(dev)               # phase 3c, C6
    for e in moe_entries:
        e["max_abs_err"] = max(e["max_abs_err"], gemm_errs[e["name"]])
    torch.cuda.empty_cache()
    sampler = check_sampler(dev)                    # phase 3g
    torch.cuda.empty_cache()
    entry["launches"], bf16_outs, bf16_tps = serve(dev)   # phase 4
    torch.cuda.empty_cache()
    sampler["launches"] = serve_sampled(dev, bf16_outs, bf16_tps)  # 11
    torch.cuda.empty_cache()
    sampler["launches"] += generate_phase(dev)      # phase 12
    torch.cuda.empty_cache()
    kv8_launches, _, _ = serve(dev, "int8", bf16_outs)   # phase 8
    torch.cuda.empty_cache()
    ladder = serve_ladder(dev)                      # phase 9
    torch.cuda.empty_cache()
    entry["launches"] += serve_domain(dev)          # phase 9b
    for e, key in zip(family, FAMILY):
        e["launches"] = kv8_launches if key == "fused_rope_q8" \
            else ladder[key]
    torch.cuda.empty_cache()
    paged["launches"] = decode_cache(dev)           # phase 10
    torch.cuda.empty_cache()
    launches = train(dev)
    torch.cuda.empty_cache()
    compare_step(dev)
    torch.cuda.empty_cache()
    compare_step(dev, use_amp=False)
    for e, key in zip(training_entries, ("forward", "dq", "dkv", "ce")):
        e["launches"] = launches[key]
    torch.cuda.empty_cache()
    int8_launches = serve_mixtral_int8(dev)
    torch.cuda.empty_cache()
    float_launches = serve_mixtral_bf16(dev)
    for e, counts in zip(moe_entries, (float_launches, int8_launches,
                                       int8_launches)):
        e["launches"] = counts[e["name"]]
    print(f"smoke_s={time.perf_counter() - t0:.1f} (build and every phase)",
          flush=True)
    print(json.dumps({"kernels": [entry] + family + [paged]
                      + training_entries + moe_entries + [sampler]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
