#!/usr/bin/env python3
"""The decode paged attention kernel (#4) of two or more checkouts of
``paddle_tpu_torch`` on one card, in alternating order.

    python3 tools/torch_paged_attention_ab.py TREE [TREE ...]

Each TREE is the root of a checkout holding ``chip_smoke.py`` and
``paddle_tpu_torch/``. The trees run in the given order and then in
reverse (A B B A for two trees), each in a process of its own started in
that tree: it builds the tree's kernel and runs its ``chip_smoke.py``
phase 3e (``check_paged_kernel``: the kernel against its plain version
at the decode shape, bf16 and f32, and at Llama-3-8B's full context),
which prints each shape's errors and times. Needs one card; exits
non-zero if any tree's check fails.
"""

import os
import subprocess
import sys

CHILD = ("import sys, torch; sys.path.insert(0, '.'); import chip_smoke as cs; "
         "from paddle_tpu_torch.ops import _build; "
         "_build.build_all(['paged_attention', 'ragged_paged_attention']); "
         "cs.check_paged_kernel(torch.device('cuda'))")


def main():
    trees = [os.path.abspath(t) for t in sys.argv[1:]]
    if not trees:
        sys.exit(__doc__)
    rc = 0
    for tree in trees + trees[::-1]:
        print(f"tree {tree}", flush=True)
        rc |= subprocess.run([sys.executable, "-c", CHILD], cwd=tree).returncode
    sys.exit(rc)


if __name__ == "__main__":
    main()
