"""Llama pretraining recipe on the port (counterpart of the reference
repository's ``examples/llama_pretrain.py``): f32 parameters, optional
bf16 ``auto_cast`` and per-layer recompute, AdamW (weight decay 0.1),
seeded synthetic token ids through ``DevicePrefetcher``, and one line
per step with its loss, time, tokens/s and TFLOP/s.

On the CPU (the plain PyTorch version of every kernel):

    python -m paddle_tpu_torch.examples.llama_pretrain --config tiny --device cpu

On the card (flash attention and the fused cross-entropy kernels; the
8B width at a cut depth fits one 80 GB card):

    python -m paddle_tpu_torch.examples.llama_pretrain --config 8b \\
        --layers 8 --batch 2 --seq 2048 --amp --steps 10

``--mesh``, ``--moe``, ``--ep``, ``--ckpt-dir`` and ``--data`` are not
ported yet and raise, naming their ROADMAP items.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from paddle_tpu_torch import amp
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.io import DevicePrefetcher
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     llama3_8b_config, tiny_llama_config)
from paddle_tpu_torch.optimizer import AdamW

__all__ = ["CONFIGS", "build_model", "synthetic_batches", "train", "main"]

CONFIGS = {
    "tiny": lambda: tiny_llama_config(num_hidden_layers=2),
    "0.5b": lambda: LlamaConfig(
        vocab_size=32000, hidden_size=2048, intermediate_size=5632,
        num_hidden_layers=8, num_attention_heads=16,
        num_key_value_heads=8, max_position_embeddings=4096),
    "8b": llama3_8b_config,
}

#: options of the reference recipe that wait for later slices
_UNPORTED = {
    "mesh": "ROADMAP queue A, item 12 (distributed)",
    "moe": "ROADMAP queue A, item 10 (MoE)",
    "ep": "ROADMAP queue A, item 10 (MoE)",
    "ckpt_dir": "ROADMAP queue A, item 9 (checkpoint_manager.py)",
    "data": "ROADMAP queue A, item 9 (TokenFeed)",
}


def build_model(config, layers=None, device=None, seed=0, recompute=False):
    """``CONFIGS[config]`` (depth cut to ``layers`` when given) with f32
    weights drawn from a seeded generator on ``device`` (default
    ``cuda``)."""
    cfg = CONFIGS[config]()
    if layers:
        cfg.num_hidden_layers = layers
    cfg.recompute = recompute
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return LlamaForCausalLM(cfg, device=dev, generator=gen)


def synthetic_batches(vocab_size, batch, seq, seed=1):
    """Endless seeded ``[batch, seq + 1]`` int64 token ids (its own
    stream: the prefetch worker draws it concurrently)."""
    rng = np.random.RandomState(seed)
    while True:
        yield rng.randint(0, vocab_size, (batch, seq + 1)).astype(np.int64)


def _split(ids):
    return (np.ascontiguousarray(ids[:, :-1]),
            np.ascontiguousarray(ids[:, 1:]))


def train(model, steps, batch, seq, *, lr=3e-4, weight_decay=0.1,
          use_amp=False, source=None, log=print):
    """Train ``model`` for ``steps`` AdamW steps on ``[batch, seq]``
    next-token batches from ``source`` (host ``[batch, seq + 1]`` id
    arrays; default :func:`synthetic_batches`), on the model's device.
    Returns ``{"losses", "step_s", "stall_s", "wall_s"}``; each step's
    time ends in the host reading its loss."""
    device = next(model.parameters()).device
    opt = AdamW(learning_rate=lr, weight_decay=weight_decay,
                parameters=model.named_parameters())
    if source is None:
        source = synthetic_batches(model.config.vocab_size, batch, seq)
    flops_step = model.flops_per_token(seq) * batch * seq

    def step(ids, labels):
        with amp.auto_cast(enable=use_amp, dtype="bfloat16"):
            loss, _ = model(ids, labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    losses, times = [], []
    with DevicePrefetcher(source, transform=_split, device=device) as feed:
        feed.mark()
        last = time.perf_counter()
        for i in range(steps):
            ids, labels = next(feed)
            lossf = step(ids, labels).item()     # host sync
            now = time.perf_counter()
            dt, last = now - last, now
            losses.append(lossf)
            times.append(dt)
            log(f"step {i:4d} loss {lossf:8.4f} {dt * 1e3:8.1f} ms "
                f"{batch * seq / dt:10.0f} tok/s "
                f"{flops_step / dt / 1e12:6.2f} TFLOP/s")
        stall, wall = feed.mark()
    log(f"input_stall_frac {stall / wall:.3f} ({stall * 1e3:.1f} ms "
        f"blocked on input over {wall:.2f} s)")
    return {"losses": losses, "step_s": times, "stall_s": stall,
            "wall_s": wall}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="tiny", choices=sorted(CONFIGS))
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config's depth to this many layers")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--amp", action="store_true", help="bf16 auto_cast")
    ap.add_argument("--recompute", action="store_true",
                    help="checkpoint every decoder layer")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--moe", type=int, default=0)
    ap.add_argument("--ep", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--data", default=None)
    args = ap.parse_args(argv)
    for opt, item in _UNPORTED.items():
        if getattr(args, opt):
            flag = "--" + opt.replace("_", "-")
            raise NotImplementedError(f"{flag} is not ported yet ({item})")

    model = build_model(args.config, args.layers, args.device, args.seed,
                        args.recompute)
    cfg = model.config
    seq = args.seq or (16 if args.config == "tiny" else 2048)
    print(f"config={args.config} layers={cfg.num_hidden_layers} "
          f"params={model.num_params():,} device={args.device} seq={seq} "
          f"batch={args.batch} amp={args.amp} recompute={args.recompute}",
          flush=True)
    return train(model, args.steps, args.batch, seq, lr=args.lr,
                 use_amp=args.amp,
                 source=synthetic_batches(cfg.vocab_size, args.batch, seq,
                                          seed=args.seed + 1),
                 log=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
