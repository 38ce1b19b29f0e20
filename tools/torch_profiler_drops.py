#!/usr/bin/env python3
"""How often ``torch.profiler`` (CUPTI) leaves out records of kernels
that ran in its window, and where in the window they were, on one card.

    python3 tools/torch_profiler_drops.py [--windows N] [--pad-ms P ...]
                                          [--step-cycles C ...]

A window opens ``torch.profiler.profile(activities=[CUDA])`` as
``chip_smoke.py``'s ``device_ms_by_kernel`` and ``profiled_launches`` do,
runs 20 spin kernels (``torch.cuda._sleep``) of distinct lengths, kernel
i spinning (i + 1) * C cycles, synchronizes and closes. For each step C
and each pad P it opens N windows, each sleeping P ms on the host after
the window opens and again after the kernels end, before it closes; P =
0 is the smoke's window. It counts the kernels each window recorded and
tells a missing kernel's place (the first ones, the last ones, some in
the middle, or all of them) by the lengths of those recorded. One line
per (C, P):

    drops: step_cycles=C pad_ms=P windows=N missing=M windows_short=W
           all=.. first=.. last=.. middle=.. extra=..

Then, over N windows that record the host's side too (CPU activity), the
least time from a kernel's launch call to its start on the device:

    clock: step_cycles=C launch_to_start_us_min=.. median=..

(negative: the trace puts a kernel's start before its launch, so the
device's timestamps and the host's are not on one clock). Needs one
card; prints the card's name and power limit first.
"""

import argparse
import statistics
import subprocess
import time

KERNELS = 20


def window(torch, step, pad_s, cpu=False):
    """One profiler window over the 20 spin kernels; returns the device
    kernels' (start_us, duration_us) and, with ``cpu``, the launch
    calls' start_us."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        if pad_s:
            time.sleep(pad_s)
        for i in range(KERNELS):
            torch.cuda._sleep((i + 1) * step)
        torch.cuda.synchronize()
        if pad_s:
            time.sleep(pad_s)
    kernels, launches = [], []
    for e in prof.events():
        if getattr(e, "is_user_annotation", False):
            continue
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((e.time_range.start,
                            e.time_range.end - e.time_range.start))
        elif "LaunchKernel" in e.name:
            launches.append(e.time_range.start)
    return sorted(kernels), sorted(launches)


def place(durations, calib):
    """Where the missing kernels of one window were: None if it has
    them all, 'all', 'first', 'last' or 'middle' (each recorded kernel
    matched to the nearest of the complete window's lengths ``calib``);
    'extra' if it has more."""
    if len(durations) > KERNELS:
        return "extra"
    if len(durations) == KERNELS:
        return None
    if not durations:
        return "all"
    found = {min(range(KERNELS), key=lambda j: abs(d - calib[j]))
             for d in durations}
    missing = set(range(KERNELS)) - found
    if not missing:
        return None
    if max(missing) < min(found):
        return "first"
    if min(missing) > max(found):
        return "last"
    return "middle"


def main():
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--windows", type=int, default=300)
    ap.add_argument("--pad-ms", type=float, nargs="+", default=[0.0, 20.0])
    ap.add_argument("--step-cycles", type=int, nargs="+",
                    default=[2000, 20000])
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    torch.cuda._sleep(1000)
    for step in a.step_cycles:
        calib = None
        while calib is None:  # a complete window gives each kernel's length
            ks, _ = window(torch, step, 0.05)
            if len(ks) == KERNELS:
                calib = [d for _, d in ks]
        for pad in a.pad_ms:
            places, missing = [], 0
            for _ in range(a.windows):
                ks, _ = window(torch, step, pad / 1e3)
                missing += max(0, KERNELS - len(ks))
                places.append(place([d for _, d in ks], calib))
            short = [p for p in places if p]
            print(f"drops: step_cycles={step} pad_ms={pad} "
                  f"windows={a.windows} missing={missing} "
                  f"windows_short={len(short)} "
                  + " ".join(f"{k}={short.count(k)}" for k in
                             ("all", "first", "last", "middle", "extra")),
                  flush=True)
        gaps = []
        for _ in range(a.windows):
            ks, ls = window(torch, step, 0.0, cpu=True)
            if len(ks) == len(ls):
                gaps += [k - s for (k, _), s in zip(ks, ls)]
        print(f"clock: step_cycles={step} pairs={len(gaps)} "
              f"launch_to_start_us_min={min(gaps) if gaps else None} "
              f"median={statistics.median(gaps) if gaps else None}",
              flush=True)


if __name__ == "__main__":
    main()
