#!/usr/bin/env python3
"""Where the time goes when ``paddle_tpu_torch`` serves Llama-3-8B.

    python3 tools/torch_serving_profile.py [--out PATH]

Runs the workload of ``chip_smoke.py`` phase 4, taken from its
``serving_workload`` (random bf16 Llama-3-8B weights from a seeded
generator on the card, 8 prompts of 64-512 tokens, 32 new tokens each,
``max_batch=8``, ``page_size=16``) once to warm up, then twice: once
timing every dispatch on the host clock (with a device synchronise
after each, split into mixed prefill+decode dispatches and decode-only
ones), once under ``torch.profiler`` for the device time by
kernel and the share of wall time with no kernel running. Prints one
JSON object; ``--out`` also writes it to a file. Needs one card.
"""

import argparse
import collections
import json
import os
import sys
import time


def workload():
    import torch
    from chip_smoke import NEW, serving_workload
    from paddle_tpu_torch.inference import Request
    cfg, _, engine, prompts = serving_workload(torch.device("cuda"))

    def run():
        reqs = [Request(p, max_new_tokens=NEW) for p in prompts]
        engine.generate(reqs)
        return reqs
    run()                                        # warm-up
    return cfg, engine, run


def dispatch_times(engine, run):
    """Host-clock time of each dispatch, synchronised, by kind."""
    import torch
    times = collections.defaultdict(list)
    inner = engine._dispatch_rows

    def timed(rows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(rows)
        torch.cuda.synchronize()
        mixed = any(n > 1 or not dec for _, _, _, n, _, dec in rows)
        times["mixed" if mixed else "decode"].append(
            time.perf_counter() - t0)
        return out
    engine._dispatch_rows = timed
    t0 = time.perf_counter()
    reqs = run()
    wall = time.perf_counter() - t0
    engine._dispatch_rows = inner
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
        if e.device_type != torch.autograd.DeviceType.CUDA:
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
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_serving_profile: no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from chip_smoke import card_line
    card = card_line()
    cfg, engine, run = workload()
    times, wall, reqs = dispatch_times(engine, run)
    by_name, busy_us, window_us, prof_wall = profile(run)
    total = sum(by_name.values()) or 1.0
    attn = sum(v for k, v in by_name.items()
               if "rope_kv_write" in k or "ragged_attention_rope" in k)
    res = {
        "card": card, "layers": cfg.num_hidden_layers,
        "wall_s": wall, "generated_tokens": sum(len(r.output_ids)
                                                for r in reqs),
        "tokens_per_s": sum(len(r.output_ids) for r in reqs) / wall,
        "ttft_ms": sorted(1e3 * r.ttft for r in reqs),
        "dispatches": {k: len(v) for k, v in times.items()},
        "dispatch_ms_mean": {k: 1e3 * sum(v) / len(v)
                             for k, v in times.items()},
        "dispatch_s_total": {k: sum(v) for k, v in times.items()},
        "profiled_wall_s": prof_wall,
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": (1 - busy_us / (prof_wall * 1e6))
        if busy_us else None,
        "attention_kernel_share_of_device_time": attn / total,
        "top_kernels_ms": {k: v / 1e3 for k, v in by_name.most_common(12)},
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
