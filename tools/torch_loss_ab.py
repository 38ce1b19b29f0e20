#!/usr/bin/env python3
"""The fused linear cross-entropy forward kernel (#5) of two or more
checkouts of ``paddle_tpu_torch`` on one card, in alternating order.

    python3 tools/torch_loss_ab.py TREE [TREE ...]

Each TREE is the root of a checkout holding ``chip_smoke.py`` and
``paddle_tpu_torch/``. The trees run in the given order and then in
reverse (A B B A for two trees), each in a process of its own started in
that tree: it builds the tree's loss kernel and runs it at ``chip_smoke.py``
phase 3b's shape (N = D = 4096, V = 128256, f32 hidden and weight from
seed 3, 5% of rows ignored), holds lse and pick against the plain version
(phase 3b's 1e-4 of max(|x|, 1)), then times the kernel by CUDA events
and by the profiler's device time, and the library call (``F.linear`` +
``F.cross_entropy`` in f32, TF32 off) the same way, and prints one line
``ab: ce_ms=... ce_device_ms=... library_ms=... library_device_ms=...``.
Needs one card; exits non-zero if any tree's check fails.
"""

import os
import subprocess
import sys

CHILD = """
import sys, torch
import torch.nn.functional as F
sys.path.insert(0, '.')
import chip_smoke as cs
from paddle_tpu_torch.ops import _build, fused_linear_cross_entropy as FC
_build.build_all(['fused_linear_cross_entropy'])
dev = torch.device('cuda')
g = torch.Generator(dev).manual_seed(3)
h = torch.randn(cs.CE_N, cs.CE_D, device=dev, generator=g)
w = torch.randn(cs.CE_V, cs.CE_D, device=dev, generator=g) * 0.02
lab = torch.randint(0, cs.CE_V, (cs.CE_N,), device=dev, generator=g)
lab[torch.rand(cs.CE_N, device=dev, generator=g) < cs.CE_IGNORED] = -100
lse, pick = FC._launch(h, w, lab)
lse_r, pick_r = FC.fused_linear_cross_entropy_ref(h, w, lab,
                                                  FC.default_chunk())
torch.cuda.synchronize()
for name, got, ref in (('lse', lse, lse_r), ('pick', pick, pick_r)):
    rel = float(((got - ref).abs() / ref.abs().clamp_min(1.0)).max())
    if not rel <= cs.CE_REL:
        sys.exit(f'ab: loss kernel {name} differs by {rel:.3e} > {cs.CE_REL}')
del lse_r, pick_r
torch.backends.cuda.matmul.allow_tf32 = False
run = lambda: FC._launch(h, w, lab)
lib = lambda: F.cross_entropy(F.linear(h, w), lab, ignore_index=-100)
print(f'ab: ce_ms={cs.time_ms(run, 3, 1):.3f} '
      f'ce_device_ms={cs.device_ms(run, 3):.3f} '
      f'library_ms={cs.time_ms(lib, 3, 1):.3f} '
      f'library_device_ms={cs.device_ms(lib, 3):.3f}', flush=True)
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
