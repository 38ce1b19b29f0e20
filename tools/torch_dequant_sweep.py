#!/usr/bin/env python3
"""Device time of the dequant matmul's cluster instance (#8) against its
K split: how the time follows the K rows each block walks.

    python3 tools/torch_dequant_sweep.py

For N = 4096 and 1024 (Mixtral-8x7B's q/o and k/v projections, K =
4096, block 128) and T = 1, 8, 32 and 64 rows of bf16 x, launches the
kernel with 1, 2, 4 and 8 K splits (the blocks of a thread-block
cluster; ``cluster_splits`` picks 8 at these shapes) and prints the
profiler's device ms of each, one line per (N, T). Needs one card.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    import torch
    import chip_smoke as cs
    from paddle_tpu_torch.quant import kernels as QK
    from paddle_tpu_torch.quant.format import quantize_weight
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    chosen = QK.cluster_splits
    for n in (4096, 1024):
        w = torch.randn(4096, n, device=dev, generator=g) * 0.02
        q, s = quantize_weight(w, 128)
        for t in (1, 8, 32, 64):
            x = torch.randn(t, 4096, device=dev, generator=g).bfloat16()
            line = []
            for splits in (1, 2, 4, 8):
                QK.cluster_splits = lambda *a, n_=splits: n_
                ms = cs.device_ms(lambda: QK._launch(x, q, s, 128))
                line.append(f"splits_{splits}={ms:.4f}")
            QK.cluster_splits = chosen
            print(f"N={n} T={t} cluster_splits="
                  f"{chosen(dev, 4096, n, 128)} device_ms: " + " ".join(line),
                  flush=True)


if __name__ == "__main__":
    main()
