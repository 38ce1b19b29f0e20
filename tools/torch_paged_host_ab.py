#!/usr/bin/env python3
"""Where ``PagedKVCache.attend``'s host time goes, for two or more
checkouts of ``paddle_tpu_torch`` on one card, in alternating order.

    python3 tools/torch_paged_host_ab.py TREE [TREE ...]

Each TREE is the root of a checkout holding ``chip_smoke.py`` and
``paddle_tpu_torch/``. The trees run in the given order and then in
reverse (A B B A for two trees), each in a process of its own started in
that tree, on ``chip_smoke.py`` phase 10's cache (12288 pages x 8 kv
heads x 16 slots x 128, bf16; 32 sequences of 1-8160 tokens from the
phase's seed; the pools left at zeros, which costs the kernel the same
work). Each step extends every sequence by one token and times, on the
host clock (medians over the steps, microseconds): ``batch_views``
(synchronised after its copy), the wrapper's checks (``_check``), the
wrapper's call up to its return (checks, conversions, scratch, the C
entry: the launch's host cost), and ``attend`` whole, synchronised, with
the device time of its launches (CUDA events). Needs one card.
"""

import os
import subprocess
import sys

CHILD = r'''
import statistics, sys, time
import numpy as np, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from paddle_tpu_torch.inference import PagedKVCache
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import paged_attention as PA
_build.build_all(["paged_attention", "ragged_paged_attention"])
dev = torch.device("cuda")
cache = PagedKVCache(cs.CACHE_PAGES, cs.PAGE, cs.HK, cs.D,
                     dtype=torch.bfloat16, device=dev)
rng = np.random.RandomState(10)
live = list(range(cs.CACHE_ROWS))
for sid, n in zip(live, rng.randint(1, cs.CACHE_PROMPT + 1,
                                    len(live)).tolist()):
    cache.admit(sid, n)
g = torch.Generator(dev).manual_seed(10)
q = torch.randn(len(live), cs.H, cs.D, device=dev, dtype=torch.bfloat16,
                generator=g)
kp, vp = cache.k_pages, cache.v_pages
t = {k: [] for k in ("batch_views", "check", "call", "attend", "device")}
for step in range(60):
    for sid in live:
        cache.extend(sid, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tables, lens = cache.batch_views(live, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    PA._check(q, kp, vp, tables, lens)
    t2 = time.perf_counter()
    PA.paged_attention(q, kp, vp, tables, lens)
    t3 = time.perf_counter()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t4 = time.perf_counter()
    start.record()
    cache.attend(live, q)
    end.record()
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    if step >= 10:
        for k, v in (("batch_views", t1 - t0), ("check", t2 - t1),
                     ("call", t3 - t2), ("attend", t5 - t4)):
            t[k].append(1e6 * v)
        t["device"].append(1e3 * start.elapsed_time(end))
keys = sum(cache.context_len(s) for s in live)
print("host_us " + " ".join(f"{k}={statistics.median(v):.1f}"
                            for k, v in t.items())
      + f" (median of {len(t['attend'])} steps; device: CUDA events "
      f"around attend, us) rows={len(live)} keys={keys}", flush=True)
'''


def main():
    trees = [os.path.abspath(t) for t in sys.argv[1:]]
    if not trees:
        sys.exit(__doc__)
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"])
    rc = 0
    for tree in trees + trees[::-1]:
        print(f"tree {tree}", flush=True)
        rc |= subprocess.run([sys.executable, "-c", CHILD],
                             cwd=tree).returncode
    sys.exit(rc)


if __name__ == "__main__":
    main()
