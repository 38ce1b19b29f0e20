"""Where a training step's time goes on the card: the pretraining
recipe's workload (Llama-3-8B width cut to ``--layers``, batch 2 x seq
2048, bf16 ``auto_cast``, AdamW, one fixed seeded batch) under
a few warm-up steps, then ``--active`` steps under ``torch.profiler``.
Prints the step time, the device's busy and idle share of the profiled
steps, device time grouped by kernel family, and the costliest
kernels.

    python -m paddle_tpu_torch.examples.profile_pretrain [--layers 8]

Run it on the card; it fails without one. Print the card's name and
power limit beside any number taken from it.
"""

from __future__ import annotations

import argparse
import collections
import itertools

import numpy as np
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from paddle_tpu_torch.examples.llama_pretrain import build_model, train

#: kernel-name fragment -> family, first match wins
FAMILIES = [
    ("flash_fwd", "flash forward (#1)"),
    ("flash_dq", "flash dQ (#2)"),
    ("flash_dkv", "flash dK/dV (#3)"),
    ("linear_ce_fwd", "loss forward (#5)"),
    ("gemm", "GEMM (cuBLAS)"),
    ("xmma", "GEMM (cuBLAS)"),
    ("cutlass", "GEMM (cuBLAS)"),
    ("nvjet", "GEMM (cuBLAS)"),
    ("Memcpy", "copies"),
    ("Memset", "copies"),
]


def family(name):
    for frag, fam in FAMILIES:
        if frag.lower() in name.lower():
            return fam
    return "elementwise and reductions"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--active", type=int, default=2)
    ap.add_argument("--top", type=int, default=12,
                    help="also print this many kernels by device time")
    args = ap.parse_args(argv)
    model = build_model("8b", args.layers, "cuda", seed=0)
    ids = np.random.RandomState(0).randint(
        0, model.config.vocab_size,
        (args.batch, args.seq + 1)).astype(np.int64)
    source = itertools.repeat(ids)
    # warm-up outside the profiler: kernel builds, allocator, cuBLAS plans
    warm = train(model, args.warmup, args.batch, args.seq, use_amp=True,
                 source=source, log=lambda line: print(line, flush=True))
    # each step ends in the host reading its loss, so the device work of
    # the profiled steps is complete when train returns
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = train(model, args.active, args.batch, args.seq, use_amp=True,
                    source=source,
                    log=lambda line: print("profiled " + line, flush=True))
    wall_ms = 1e3 * sum(res["step_s"])
    by_family, by_kernel = collections.Counter(), collections.Counter()
    for ev in prof.key_averages():
        # kernels and copies only: a host op's device time repeats the
        # time of the kernels it launched, and an annotation's device
        # span covers kernels counted on their own
        if ev.device_type != DeviceType.CUDA \
                or getattr(ev, "is_user_annotation", False) \
                or ev.key.startswith("ProfilerStep"):
            continue
        t = ev.self_device_time_total / 1e3       # us -> ms
        if t > 0:
            by_family[family(ev.key)] += t
            by_kernel[ev.key] += t
    busy = sum(by_family.values())
    steps = args.active
    print(f"unprofiled step_ms={1e3 * warm['step_s'][-1]:.1f} (last "
          f"warm-up step)", flush=True)
    print(f"profiled {steps} steps: wall_ms={wall_ms:.1f} device_busy_ms="
          f"{busy:.1f} idle_share={max(0.0, 1 - busy / wall_ms):.3f}",
          flush=True)
    for fam, t in by_family.most_common():
        print(f"  {fam}: {t / steps:.1f} ms/step ({100 * t / busy:.1f}% of "
              "device time)", flush=True)
    for name, t in by_kernel.most_common(args.top):
        print(f"  kernel {t / steps:8.2f} ms/step  {name[:110]}", flush=True)


if __name__ == "__main__":
    main()
