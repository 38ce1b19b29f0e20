#!/usr/bin/env python3
"""The GEMM kernels (#6 grouped GEMM, #7 int8 grouped GEMM, #8 dequant
matmul) of two or more checkouts of ``paddle_tpu_torch`` on one card, in
alternating order.

    python3 tools/torch_tile_gemm_ab.py TREE [TREE ...]

Each TREE is the root of a checkout holding ``chip_smoke.py`` and
``paddle_tpu_torch/``. The trees run in the given order and then in
reverse (A B B A for two trees), each in a process of its own started in
that tree: it builds the tree's two GEMM libraries and runs ``chip_smoke.py``
phase 3c's timed cases on inputs made the same way in every tree (a
Mixtral-8x7B-width ``LlamaMoEMLP`` from seed 5: #6 and #7 on the gate/up
and down shapes routed by its router at T = 8 and 64 tokens, #6's dx of
gate/up too (the transposed weight read in place), #8 on q/o (N = 4096)
and k/v (N = 1024) weights at T = 8 and 64, bf16, block 128).
Every case is held against its plain version (phase 3's bound), then
timed by CUDA events (which include the wrapper's host time between
launches at these sizes) and by the profiler's device time, beside its
library call's device time (phase 3c's: ``torch.bmm`` on the masked rows
against the bf16 weight, bf16-dequantized for #7; ``F.linear`` on the
bf16-dequantized weight for #8); each process prints one line ``ab:
<case>_ms=... <case>_device_ms=... <case>_library_device_ms=... ...``.
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
from paddle_tpu_torch.ops import _build, grouped_gemm as GG
from paddle_tpu_torch.quant import kernels as QK
from paddle_tpu_torch.quant.format import dequant_blocks, quantize_weight
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaMoEMLP
_build.build_all(['grouped_gemm', 'dequant_matmul'])
dev = torch.device('cuda')
cfg = LlamaConfig(**cs.MIXTRAL)
d, f, bf, B = cfg.hidden_size, cfg.intermediate_size, torch.bfloat16, \\
    cs.WEIGHT_BLOCK
g = torch.Generator(dev).manual_seed(5)
mlp = LlamaMoEMLP(cfg, device=dev, dtype=bf)
mlp.reset_parameters(cfg.initializer_range, g)
xs = {t: torch.randn(t, d, device=dev, dtype=bf, generator=g)
      for t in cs.MOE_TOKENS}
hs = {t: torch.randn(8 * t, f, device=dev, dtype=bf, generator=g)
      for t in cs.MOE_TOKENS}
cases = {}
for t in cs.MOE_TOKENS:
    slot, *_, gs = mlp.route(xs[t])
    xg = xs[t][slot.clamp_min(0)]
    wu, wd = mlp.gate_proj.detach(), mlp.down_proj.detach()
    cases[f'gg_up_t{t}'] = (lambda x=xg, w=wu, s=gs: GG._launch_float(x, w, s),
                            lambda x=xg, w=wu, s=gs: GG.grouped_gemm_ref(x, w, s),
                            lambda x=cs.masked_rows(xg, gs), w=wu: torch.bmm(x, w))
    cases[f'gg_down_t{t}'] = (lambda x=hs[t], w=wd, s=gs: GG._launch_float(x, w, s),
                              lambda x=hs[t], w=wd, s=gs: GG.grouped_gemm_ref(x, w, s),
                              lambda x=cs.masked_rows(hs[t], gs), w=wd: torch.bmm(x, w))
    wt = wu.transpose(1, 2)
    cases[f'gg_dx_t{t}'] = (lambda g=hs[t], w=wt, s=gs: GG._launch_float(g, w, s),
                            lambda g=hs[t], w=wt, s=gs: GG.grouped_gemm_ref(g, w, s),
                            lambda g=cs.masked_rows(hs[t], gs), w=wt: torch.bmm(g, w))
    cases[f'gs_t{t}'] = (gs, xg)
mlp.quantize_weights(B)
for t in cs.MOE_TOKENS:
    gs, xg = cases.pop(f'gs_t{t}')
    qu, su = mlp.gate_proj, mlp.gate_proj_scale
    qd, sd = mlp.down_proj, mlp.down_proj_scale
    lu, ld = (dequant_blocks(q, s, B).to(bf) for q, s in ((qu, su), (qd, sd)))
    cases[f'q8_up_t{t}'] = (
        lambda x=xg, q=qu, s=su, n=gs: GG._launch_q8(x, q, s, n, B),
        lambda x=xg, q=qu, s=su, n=gs: GG.grouped_gemm_q8_ref(x, q, s, n, B),
        lambda x=cs.masked_rows(xg, gs), w=lu: torch.bmm(x, w))
    cases[f'q8_down_t{t}'] = (
        lambda x=hs[t], q=qd, s=sd, n=gs: GG._launch_q8(x, q, s, n, B),
        lambda x=hs[t], q=qd, s=sd, n=gs: GG.grouped_gemm_q8_ref(x, q, s, n, B),
        lambda x=cs.masked_rows(hs[t], gs), w=ld: torch.bmm(x, w))
for n in (4096, 1024):
    q, s = quantize_weight(torch.randn(d, n, device=dev, generator=g) * 0.02, B)
    w_lib = dequant_blocks(q, s, B).t().contiguous().to(bf)
    for t in cs.MOE_TOKENS:
        cases[f'dq_n{n}_t{t}'] = (
            lambda x=xs[t], q=q, s=s: QK._launch(x, q, s, B),
            lambda x=xs[t], q=q, s=s: QK.dequant_matmul_ref(x, q, s, B),
            lambda x=xs[t], w=w_lib: F.linear(x, w))
line = []
for name, (run, plain, lib) in cases.items():
    y, ref = run(), plain()
    torch.cuda.synchronize()
    cs.check_close(f'ab {name}', y, ref)
    line.append(f'{name}_ms={cs.time_ms(run):.4f} '
                f'{name}_device_ms={cs.device_ms(run):.4f} '
                f'{name}_library_device_ms={cs.device_ms(lib):.4f}')
print('ab: ' + ' '.join(line), flush=True)
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
