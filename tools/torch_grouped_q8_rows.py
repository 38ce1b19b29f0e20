#!/usr/bin/env python3
"""The int8 grouped GEMM (#7) on the same routed rows at several row
strides, on one card.

    python3 tools/torch_grouped_q8_rows.py

Builds ``chip_smoke.py`` phase 3c's inputs (a Mixtral-8x7B-width
``LlamaMoEMLP`` from seed 5, its gate/up weight quantized at block 128,
the rows its router gives 8 and 64 tokens), then runs #7 on those rows
laid out at expert strides C = 8 and 64 (the 8 tokens) and 64, 32 and 16
(the 64 tokens, each expert's rows clipped to C): the same live rows
through the kernel's 16-, 32- and 64-row instances. Each case is held
against the plain version (phase 3's bound) and prints its group sizes,
its instance and its device time by the profiler. Needs one card.
"""

import os
import sys


def main():
    sys.path.insert(0, os.getcwd())
    import torch
    import chip_smoke as cs
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaMoEMLP
    from paddle_tpu_torch.ops import _build, grouped_gemm as GG
    _build.build_all(["grouped_gemm"])
    dev = torch.device("cuda")
    cfg = LlamaConfig(**cs.MIXTRAL)
    bf, block = torch.bfloat16, cs.WEIGHT_BLOCK
    g = torch.Generator(dev).manual_seed(5)
    mlp = LlamaMoEMLP(cfg, device=dev, dtype=bf)
    mlp.reset_parameters(cfg.initializer_range, g)
    routed = {}
    for t in cs.MOE_TOKENS:
        x = torch.randn(t, cfg.hidden_size, device=dev, dtype=bf,
                        generator=g)
        slot, *_, gs = mlp.route(x)
        routed[t] = (x[slot.clamp_min(0)], gs, t)
    mlp.quantize_weights(block)
    q, s = mlp.gate_proj, mlp.gate_proj_scale

    def strided(x, gs, c_old, c_new):
        e = gs.numel()
        out = torch.zeros(e * c_new, x.shape[1], device=dev, dtype=x.dtype)
        k = min(c_old, c_new)
        out.view(e, c_new, -1)[:, :k] = x.view(e, c_old, -1)[:, :k]
        return out, gs.clamp(max=c_new)
    cases = {"T=8 C=8": routed[8][:2],
             "T=8 C=64": strided(*routed[8], 64),
             "T=64 C=64": routed[64][:2],
             "T=64 C=32": strided(*routed[64], 32),
             "T=64 C=16": strided(*routed[64], 16)}
    for label, (x, gs) in cases.items():
        def run():
            return GG._launch_q8(x, q, s, gs, block)
        before = dict(GG.instance_launches)
        y = run()
        ran = [k for k, n in GG.instance_launches.items() if n > before[k]]
        ref = GG.grouped_gemm_q8_ref(x, q, s, gs, block)
        torch.cuda.synchronize()
        cs.check_close(label, y, ref)
        print(f"{label}: gs={gs.tolist()} instance={ran[0]} device_ms="
              f"{cs.device_ms(run):.4f}", flush=True)


if __name__ == "__main__":
    main()
