#!/usr/bin/env python3
"""Host time per call of the int8 GEMM wrappers (#7 ``_launch_q8`` and
#8 ``quant.kernels._launch``) of two or more checkouts of
``paddle_tpu_torch`` on one card, in alternating order.

    python3 tools/torch_gemm_host_ab.py TREE [TREE ...]

Each TREE is the root of a checkout. The trees run in the given order and
then in reverse (A B B A for two trees), each in a process of its own
started in that tree: at a shape whose device work is a few microseconds
(8 experts of 8 rows, K = N = 256, bf16 x, block 128; the dequant matmul
on 8 of those rows), it times 2000 back-to-back calls of each wrapper on
the host clock, synchronised at the end, after 50 warm-up calls, and
prints ``<kernel> us_per_call=...``: what the wrapper, its checks and the
launch cost the host, which sets a serving dispatch's time where the host
is the bottleneck. Needs one card.
"""

import os
import subprocess
import sys

CHILD = """
import sys, time, torch
sys.path.insert(0, '.')
from paddle_tpu_torch.ops import _build, grouped_gemm as GG
from paddle_tpu_torch.quant import kernels as QK
from paddle_tpu_torch.quant.format import quantize_weight
_build.build_all(['grouped_gemm', 'dequant_matmul'])
dev = torch.device('cuda')
g = torch.Generator(dev).manual_seed(0)
e, c, k, n, block = 8, 8, 256, 256, 128
x = torch.randn(e * c, k, device=dev, generator=g).bfloat16()
q, s = quantize_weight(torch.randn(e, k, n, device=dev, generator=g), block)
gs = torch.tensor([1, 2, 3, 1, 2, 1, 4, 2], device=dev)
q2, s2 = quantize_weight(torch.randn(k, n, device=dev, generator=g), block)
for name, fn in (('grouped_gemm_q8', lambda: GG._launch_q8(x, q, s, gs, block)),
                 ('dequant_matmul', lambda: QK._launch(x[:8], q2, s2, block))):
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        fn()
    torch.cuda.synchronize()
    print(f'{name} us_per_call={(time.perf_counter() - t0) / 2000 * 1e6:.2f}',
          flush=True)
"""


def main():
    trees = [os.path.abspath(t) for t in sys.argv[1:]]
    if not trees:
        sys.exit(__doc__)
    rc = 0
    for tree in trees + trees[::-1]:
        print(f"tree {tree}", flush=True)
        rc |= subprocess.run([sys.executable, "-c", CHILD],
                             cwd=tree).returncode
    sys.exit(rc)


if __name__ == "__main__":
    main()
