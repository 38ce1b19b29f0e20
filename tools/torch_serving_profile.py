#!/usr/bin/env python3
"""Where the time goes when ``paddle_tpu_torch`` serves a model.

    python3 tools/torch_serving_profile.py
        [--model llama3-8b|llama3-8b-kv8|mixtral-int8|mixtral-bf16]
        [--decode-ticks N] [--out PATH]

``llama3-8b`` (the default) is the workload of ``chip_smoke.py`` phase
4, taken from its ``serving_workload``: random bf16 Llama-3-8B weights
from a seeded generator on the card. ``llama3-8b-kv8`` is phase 8's: the
same model behind ``LlamaServingEngine(kv_dtype="int8")``, int8 KV pages
with f32 scale sidecars. ``mixtral-int8`` is phase 6's:
Mixtral-8x7B at full width and depth with int8 weights, built layer by
layer by ``chip_smoke.mixtral_int8``, behind
``LlamaServingEngine(weight_dtype="int8")``. ``mixtral-bf16`` is phase
7's: Mixtral-8x7B width cut to 4 bf16 layers (seeded random weights on
the card, ``chip_smoke.FLOAT_MOE_LAYERS``) behind the engine's default
float weights, the float grouped GEMM #6 in every FFN. All serve 8 prompts of
64-512 tokens, 32 new tokens each, ``max_batch=8``, ``page_size=16``,
``decode_ticks`` the engine's (``--decode-ticks``; by default decode scans
whose ticks replay CUDA graphs, 1 for single mixed steps only):
once to warm up, then twice: once timing every dispatch on the host
clock (with a device synchronise after each, split into mixed
prefill+decode dispatches, decode-only ones and decode scans, whose time
is given per tick), once under
``torch.profiler`` for the device time by kernel and by kernel family,
and the share of wall time with no kernel running (only kernels and
copies count as device time). Prints one JSON object; ``--out`` also
writes it to a file. Needs one card.
"""

import argparse
import collections
import json
import os
import sys
import time


# kernel families by a fragment of the kernel's name, first match wins;
# the tile kernels are named by their library's namespace and by their
# weight kind (template argument 1: int8), the grouped GEMMs' cluster
# instances by their own names; the ragged attention kernels (a write and
# an attention launch: the general instance's or the tensor-core
# instance's) by their instance's template arguments <rope, int8 pools,
# the model dtype, ...>, the write launch a family of its own within them
ATTENTION = {"<true, false,": "#12", "<true, true,": "#13",
             "<false, false,": "#11a/#10", "<false, true,": "#11b/#9"}
FAMILIES = [
    ("dequant_matmul::", "dequant matmul #8"),
    ("dq_cluster_kernel", "dequant matmul #8"),
    ("gemm", "GEMM (cuBLAS)"),
    ("xmma", "GEMM (cuBLAS)"),
    ("cutlass", "GEMM (cuBLAS)"),
    ("nvjet", "GEMM (cuBLAS)"),
    ("sort", "sort (routing)"),
    ("Memcpy", "copies"),
    ("Memset", "copies"),
]


def family(name):
    if any(k in name for k in ("kv_write_kernel", "ragged_attention_kernel",
                                "attention_tc")):
        for args, rows in ATTENTION.items():
            if args in name:
                return f"ragged attention {rows}" + (
                    " write" if "kv_write" in name else "")
    if "grouped_gemm::" in name:
        return "int8 grouped GEMM #7" if "_kernel<1>" in name \
            or "q8_cluster_kernel" in name else "float grouped GEMM #6"
    for frag, fam in FAMILIES:
        if frag.lower() in name.lower():
            return fam
    return "other (elementwise, reductions, indexing)"


def moe_workload(dev, decode_ticks):
    from chip_smoke import (mixtral_int8, serving_engine, serving_prompts,
                            warm_up)
    model = mixtral_int8(dev)
    engine = serving_engine(model, weight_dtype="int8",
                            decode_ticks=decode_ticks)
    prompts = serving_prompts(model.config.vocab_size)
    warm_up(engine, prompts)
    return model.config, model, engine, prompts


def moe_bf16_workload(dev, decode_ticks):
    import dataclasses
    import torch
    from chip_smoke import (FLOAT_MOE_LAYERS, MIXTRAL, serving_engine,
                            serving_prompts, warm_up)
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    cfg = dataclasses.replace(LlamaConfig(**MIXTRAL),
                              num_hidden_layers=FLOAT_MOE_LAYERS)
    model = LlamaForCausalLM(cfg, device=dev, dtype=torch.bfloat16,
                             generator=torch.Generator(dev).manual_seed(0))
    engine = serving_engine(model.eval(), decode_ticks=decode_ticks)
    prompts = serving_prompts(cfg.vocab_size)
    warm_up(engine, prompts)
    return cfg, model, engine, prompts


def workload(name, decode_ticks=None):
    import torch
    from chip_smoke import NEW, serving_workload
    from paddle_tpu_torch.inference import Request
    dev = torch.device("cuda")
    if name == "mixtral-int8":
        cfg, _, engine, prompts = moe_workload(dev, decode_ticks)
    elif name == "mixtral-bf16":
        cfg, _, engine, prompts = moe_bf16_workload(dev, decode_ticks)
    else:
        cfg, _, engine, prompts = serving_workload(
            dev, "int8" if name == "llama3-8b-kv8" else None,
            decode_ticks=decode_ticks)

    def run():
        reqs = [Request(p, max_new_tokens=NEW) for p in prompts]
        engine.generate(reqs)
        return reqs
    run()                                        # warm-up
    return cfg, engine, run


def dispatch_times(engine, run):
    """Host-clock time of each dispatch, synchronised, by kind, and of
    each decode scan with its tick count (``times["scan"]``)."""
    import torch
    times = collections.defaultdict(list)
    inner, scan = engine._dispatch_rows, engine._decode_scan

    def timed_scan(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = scan(n)
        torch.cuda.synchronize()
        times["scan"].append((time.perf_counter() - t0, n))
        return out

    def timed(rows, cow=()):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(rows, cow)
        torch.cuda.synchronize()
        mixed = any(n > 1 or not dec for _, _, _, n, _, dec in rows)
        times["mixed" if mixed else "decode"].append(
            time.perf_counter() - t0)
        return out
    engine._dispatch_rows, engine._decode_scan = timed, timed_scan
    t0 = time.perf_counter()
    reqs = run()
    wall = time.perf_counter() - t0
    del engine._dispatch_rows, engine._decode_scan
    return times, wall, reqs


def profile(run):
    import torch
    from torch.profiler import ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = collections.Counter()
    spans = []
    for e in prof.events():
        # kernels and copies only: an annotation's device span covers
        # kernels counted on their own
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or getattr(e, "is_user_annotation", False):
            continue
        tr = e.time_range
        if tr.end <= tr.start:
            continue
        by_name[e.name] += tr.end - tr.start
        spans.append((tr.start, tr.end))
    spans.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    window = (spans[-1][1] - spans[0][0]) if spans else 0.0
    return by_name, busy, window, wall


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=("llama3-8b", "llama3-8b-kv8",
                                        "mixtral-int8", "mixtral-bf16"),
                    default="llama3-8b")
    ap.add_argument("--decode-ticks", type=int, default=None,
                    help="the engine's decode_ticks (default: its own; 1 "
                    "takes single mixed steps only)")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_serving_profile: no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from chip_smoke import card_line
    card = card_line()
    cfg, engine, run = workload(args.model, args.decode_ticks)
    times, wall, reqs = dispatch_times(engine, run)
    by_name, busy_us, window_us, prof_wall = profile(run)
    total = sum(by_name.values()) or 1.0
    by_family = collections.Counter()
    for k, v in by_name.items():
        by_family[family(k)] += v
    scans = times.pop("scan", [])
    ticks = sum(n for _, n in scans)
    # a tick is a decode-only step of all max_batch rows
    n_disp = sum(len(v) for v in times.values()) + ticks or 1
    res = {
        "card": card, "model": args.model,
        "layers": cfg.num_hidden_layers,
        "decode_ticks": engine.decode_ticks,
        "wall_s": wall, "generated_tokens": sum(len(r.output_ids)
                                                for r in reqs),
        "tokens_per_s": sum(len(r.output_ids) for r in reqs) / wall,
        "ttft_ms": sorted(1e3 * r.ttft for r in reqs),
        "dispatches": {k: len(v) for k, v in times.items()},
        "dispatch_ms_mean": {k: 1e3 * sum(v) / len(v)
                             for k, v in times.items()},
        "dispatch_s_total": {k: sum(v) for k, v in times.items()},
        "scans": len(scans), "ticks": ticks,
        "tick_ms_mean": 1e3 * sum(s for s, _ in scans) / ticks
        if ticks else None,
        "scan_s_total": sum(s for s, _ in scans),
        "profiled_wall_s": prof_wall,
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": (1 - busy_us / (prof_wall * 1e6))
        if busy_us else None,
        "attention_kernel_share_of_device_time":
            sum(v for k, v in by_family.items()
                if k.startswith("ragged attention")) / total,
        "device_ms_by_family": {k: v / 1e3
                                for k, v in by_family.most_common()},
        "device_share_by_family": {k: v / total
                                   for k, v in by_family.most_common()},
        "device_ms_per_dispatch_or_tick_by_family": {
            k: v / 1e3 / n_disp for k, v in by_family.most_common()},
        "top_kernels_ms": {k: v / 1e3 for k, v in by_name.most_common(15)},
    }
    text = json.dumps(res, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)


if __name__ == "__main__":
    main()
