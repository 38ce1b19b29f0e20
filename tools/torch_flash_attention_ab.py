#!/usr/bin/env python3
"""The flash attention kernels (#1-#3) of two or more checkouts of
``paddle_tpu_torch`` on one card, in alternating order.

    python3 tools/torch_flash_attention_ab.py [--ragged] TREE [TREE ...]

Each TREE is the root of a checkout holding ``chip_smoke.py`` and
``paddle_tpu_torch/``. The trees run in the given order and then in
reverse (A B B A for two trees), each in a process of its own started in
that tree: it builds the tree's kernels and runs its ``chip_smoke.py``
phase 3b timed case (``flash_case``: the Llama-3-8B training batch, B 2 x
S 2048, 32/8 heads, head_dim 128, bf16, causal, each kernel against its
plain version), then times the three kernels again on the same inputs by
CUDA events and by the profiler's device time and prints one line
``ab: forward_ms=... forward_device_ms=... dq_ms=...``. With
``--ragged`` each process also runs the tree's phases 3 and 3d (the
ragged paged attention family at the serving shapes, with their times)
and phase 3f's long-context points (#12 and #13 on 8 decode rows over
1-8192 tokens at qblock 1 and 32) through the tree's ``check_kernel``,
then times each fused call form (#12, #13, #11a, #11b) at the mixed,
decode-only and both long-context shapes by the profiler, its write
launch apart from its attention launch (kernels named ``kv_write``), and
prints one line ``ragged: <form>_<shape>_write_device_ms=...
<form>_<shape>_attention_device_ms=... ...``.
Needs one card; exits non-zero if any tree's check fails.
"""

import os
import subprocess
import sys

CHILD = """
import math, sys, torch
sys.path.insert(0, '.')
import chip_smoke as cs
from paddle_tpu_torch.ops import _build, flash_attention as FT
_build.build_all(['flash_attention', 'ragged_paged_attention'])
dev = torch.device('cuda')
cs.flash_case(dev, 'train', cs.TRAIN_B, cs.TRAIN_S, cs.TRAIN_S, True,
              seed=1, timed=True)
g = torch.Generator(dev).manual_seed(1)
bf = dict(device=dev, dtype=torch.bfloat16, generator=g)
b, s = cs.TRAIN_B, cs.TRAIN_S
q, do = torch.randn(b, s, cs.H, cs.D, **bf), torch.randn(b, s, cs.H, cs.D, **bf)
k, v = torch.randn(b, s, cs.HK, cs.D, **bf), torch.randn(b, s, cs.HK, cs.D, **bf)
args = (q, k, v, True, 1.0 / math.sqrt(cs.D))
out, lse = FT.flash_attention_fwd_ref(*args)
bargs = (q, k, v, do, lse, FT.attention_delta(out, do), True, args[-1])
fns = {'forward': lambda: FT._launch_forward(*args),
       'dq': lambda: FT._launch_dq(*bargs),
       'dkv': lambda: FT._launch_dkv(*bargs)}
line = []
for name, fn in fns.items():
    line.append(f'{name}_ms={cs.time_ms(fn):.4f} '
                f'{name}_device_ms={cs.device_ms(fn):.4f}')
print('ab: ' + ' '.join(line), flush=True)
if RAGGED:
    cs.check_kernels(dev, ('fused_rope',) + cs.FAMILY)
    for qb in (1, cs.QB):
        for variant in ('fused_rope', 'fused_rope_q8'):
            cs.check_kernel(dev, f'long context qblock {qb}', qb,
                            (1, cs.FULL_CTX + 1), [], False, variant)
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.inference.paged_cache import quantize_kv_int8
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa

    def split_ms(fn, iters=20):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ms = {True: 0.0, False: 0.0}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA \
                    and not getattr(e, 'is_user_annotation', False):
                ms['kv_write' in e.name] += \
                    (e.time_range.end - e.time_range.start) / iters / 1e3
        return ms[True], ms[False]
    shapes = {'mixed': (cs.QB, (100, 2001), [cs.QB, cs.QB], True),
              'decode': (1, (64, 545), [], False),
              'long_qb1': (1, (1, cs.FULL_CTX + 1), [], False),
              'long_qb32': (cs.QB, (1, cs.FULL_CTX + 1), [], False)}
    line = []
    for shape, (qb, ctx, chunks, inactive) in shapes.items():
        args, _ = cs.attention_batch(dev, qb, ctx, chunks, inactive)
        kq, ks = quantize_kv_int8(args['k_pages'])
        vq, vs = quantize_kv_int8(args['v_pages'])
        pools = (kq, vq, ks[..., None], vs[..., None])
        for form in ('fused_rope', 'fused_rope_q8', 'fused', 'fused_q8'):
            a = cs.variant_args(args, form, pools)
            w, att = split_ms(
                lambda: rpa.fused_ragged_paged_attention(**a))
            line.append(f'{form}_{shape}_write_device_ms={w:.4f} '
                        f'{form}_{shape}_attention_device_ms={att:.4f}')
    print('ragged: ' + ' '.join(line), flush=True)
"""


def main():
    args = sys.argv[1:]
    ragged = "--ragged" in args
    trees = [os.path.abspath(t) for t in args if t != "--ragged"]
    if not trees:
        sys.exit(__doc__)
    child = f"RAGGED = {ragged}\n" + CHILD
    rc = 0
    for tree in trees + trees[::-1]:
        print(f"tree {tree}", flush=True)
        rc |= subprocess.run([sys.executable, "-c", child],
                             cwd=tree).returncode
    sys.exit(rc)


if __name__ == "__main__":
    main()
