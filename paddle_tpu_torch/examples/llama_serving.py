"""Continuous-batching Llama serving demo on the port (counterpart of the
reference repository's ``examples/llama_serving.py``, with its flags).

Runs the paged-attention serving engine
(``paddle_tpu_torch.inference.serving``) over a Llama model with seeded
random weights: requests with ragged prompts are admitted on the fly,
every live sequence decodes one token per engine step, and finished
sequences release their KV pages for reuse. On the card by default:

    python -m paddle_tpu_torch.examples.llama_serving --config tiny --requests 8

On the CPU (the plain version of every kernel):

    python -m paddle_tpu_torch.examples.llama_serving --config tiny --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.inference.serving import LlamaServingEngine
from paddle_tpu_torch.models import (LlamaForCausalLM, llama3_8b_config,
                                     tiny_llama_config)

__all__ = ["CONFIGS", "main"]

CONFIGS = {
    "tiny": tiny_llama_config,
    "llama3-8b": llama3_8b_config,
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="tiny", choices=sorted(CONFIGS))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = CONFIGS[args.config]()
    dtype = torch.bfloat16 if args.config == "llama3-8b" else torch.float32
    model = LlamaForCausalLM(cfg, device=dev, dtype=dtype,
                             generator=torch.Generator(dev).manual_seed(0))
    model.eval()
    print(f"config={args.config} params={model.num_params():,} "
          f"max_batch={args.max_batch} page={args.page_size} device={dev}")

    engine = LlamaServingEngine(
        model, max_batch=args.max_batch, page_size=args.page_size,
        num_pages=args.num_pages)

    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size,
                           (int(rng.randint(4, 24)),)).tolist()
               for _ in range(args.requests)]

    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_new_tokens=args.max_new_tokens)
    dt = time.perf_counter() - t0
    total = sum(len(o) for o in outs)
    print(f"served {args.requests} requests, {total} tokens "
          f"in {dt:.2f}s  ({total / dt:.1f} tok/s incl. prefill and the "
          f"kernels' first loads)")
    for i, (p, o) in enumerate(zip(prompts[:3], outs[:3])):
        print(f"  req{i}: prompt[{len(p)}] -> {o[:8]}...")
    engine.close()
    return outs


if __name__ == "__main__":
    main()
