"""Llama pretraining recipe on the port (counterpart of the reference
repository's ``examples/llama_pretrain.py``): f32 parameters, optional
bf16 ``auto_cast`` and per-layer recompute, AdamW (weight decay 0.1), a
compiled train step (:func:`paddle_tpu_torch.jit.to_static`, one CUDA
graph for the full shape, warmed up eagerly on a tiny shape first),
token batches from ``--data`` through :func:`paddle_tpu_torch.io
.TokenFeed` (else seeded synthetic ids) and ``DevicePrefetcher``, the
model and optimizer state saved to ``--ckpt-dir`` at the end and loaded
back with ``--resume`` (after the warm-up, so the optimizer state exists
to receive it), in the reference's on-disk format. One line per step
with its loss, time, tokens/s and TFLOP/s.

On the CPU (the plain PyTorch version of every kernel; the step runs
eagerly on static buffers):

    python -m paddle_tpu_torch.examples.llama_pretrain --config tiny \\
        --device cpu --data corpus.bin --ckpt-dir ckpt
    python -m paddle_tpu_torch.examples.llama_pretrain --config tiny \\
        --device cpu --data corpus.bin --ckpt-dir ckpt --resume

On the card (flash attention and the fused cross-entropy kernels inside
the captured step; the 8B width at a cut depth fits one 80 GB card):

    python -m paddle_tpu_torch.examples.llama_pretrain --config 8b \\
        --layers 8 --batch 2 --seq 2048 --amp --steps 10 \\
        --data corpus.bin --ckpt-dir ckpt

``--data`` is a flat binary file of int32 token ids, ``seq + 1`` a
sample. ``--mesh``, ``--moe`` and ``--ep`` are not ported yet and raise,
naming their ROADMAP items.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from paddle_tpu_torch import amp, jit
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.io import DevicePrefetcher, TokenFeed
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     llama3_8b_config, tiny_llama_config)
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer.lr import LRScheduler

__all__ = ["CONFIGS", "build_model", "synthetic_batches", "train",
           "train_state", "main"]

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
    "mesh": "ROADMAP queue A, item 13 (distributed)",
    "moe": "ROADMAP queue A, item 11 (MoE)",
    "ep": "ROADMAP queue A, item 11 (MoE)",
}

#: the tiny shape of the eager warm-up (the reference's ``wseq``)
WARMUP_SEQ = 128


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
    ids = ids.astype(np.int64)
    return (np.ascontiguousarray(ids[:, :-1]),
            np.ascontiguousarray(ids[:, 1:]))


def train_state(model, opt):
    """The checkpointed state: the model's and the optimizer's."""
    return {"model": model.state_dict(), "opt": opt.state_dict()}


def train(model, steps, batch, seq, *, lr=3e-4, weight_decay=0.1,
          use_amp=False, source=None, log=print, compiled=False, opt=None,
          ckpt_dir=None, resume=False):
    """Train ``model`` for ``steps`` AdamW steps on ``[batch, seq]``
    next-token batches from ``source`` (host ``[batch, seq + 1]`` id
    arrays; default :func:`synthetic_batches`), on the model's device.

    ``opt`` (default AdamW with ``lr`` and ``weight_decay``) may carry a
    schedule, which steps once after each step of the loop.
    ``compiled=True`` is the reference recipe's path: the step through
    :func:`~paddle_tpu_torch.jit.to_static` (``warmup="once"``), one eager
    step on a seeded ``[1, 128]`` batch first, then ``--resume``'s load
    from ``ckpt_dir`` (when it holds a checkpoint), then the loop, then
    the state saved to ``ckpt_dir`` (unless a resumed run took no step).
    ``compiled=False`` runs every step eagerly and neither warms up nor
    touches a checkpoint.

    Returns ``{"losses", "step_s", "stall_s", "wall_s", "model", "opt",
    "step", "feed"}`` plus, when it saved or loaded, ``"snapshot_s"``,
    ``"write_s"``, ``"load_s"`` and ``"ckpt_bytes"``; each step's time
    ends in the host reading its loss."""
    device = next(model.parameters()).device
    if opt is None:
        opt = AdamW(learning_rate=lr, weight_decay=weight_decay,
                    parameters=model.named_parameters())
    if source is None:
        source = synthetic_batches(model.config.vocab_size, batch, seq)
    flops_step = model.flops_per_token(seq) * batch * seq

    def step_fn(ids, labels):
        with amp.auto_cast(enable=use_amp, dtype="bfloat16"):
            loss, _ = model(ids, labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    sched = opt._learning_rate if isinstance(
        opt._learning_rate, LRScheduler) else None
    step = step_fn
    res = {"model": model, "opt": opt,
           "feed": f"{type(source).__module__}.{type(source).__name__}"}
    if compiled:
        step = jit.to_static(step_fn, state=[model, opt], warmup="once",
                             donate_inputs=True, name="llama_pretrain.step")
        wids = np.random.RandomState(0).randint(
            0, model.config.vocab_size,
            (1, min(seq, WARMUP_SEQ) + 1)).astype(np.int64)
        step(*(torch.from_numpy(a).to(device) for a in _split(wids)))
        meta = os.path.join(ckpt_dir, "metadata_p0.json") if ckpt_dir \
            else None
        if resume and meta and os.path.exists(meta):
            t0 = time.perf_counter()
            ckpt.load_state_dict(train_state(model, opt), ckpt_dir)
            res["load_s"] = time.perf_counter() - t0
            log(f"resumed model+optimizer from {ckpt_dir} "
                f"({res['load_s']:.2f} s)")
    res["step"] = step

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
            if sched is not None:
                sched.step()
            log(f"step {i:4d} loss {lossf:8.4f} {dt * 1e3:8.1f} ms "
                f"{batch * seq / dt:10.0f} tok/s "
                f"{flops_step / dt / 1e12:6.2f} TFLOP/s")
        stall, wall = feed.mark()
    log(f"input_stall_frac {stall / wall:.3f} ({stall * 1e3:.1f} ms "
        f"blocked on input over {wall:.2f} s)")
    res.update(losses=losses, step_s=times, stall_s=stall, wall_s=wall)
    # a resumed run that took no step holds the checkpoint it loaded
    if compiled and ckpt_dir and (steps or "load_s" not in res):
        t0 = time.perf_counter()
        proc, meta, data = ckpt.collect_state_shards(train_state(model, opt))
        t1 = time.perf_counter()
        ckpt.write_state_shards(ckpt_dir, proc, meta, data)
        res.update(snapshot_s=t1 - t0, write_s=time.perf_counter() - t1,
                   ckpt_bytes=sum(a.nbytes for a in data.values()))
        log(f"checkpoint (model+optimizer) written to {ckpt_dir}: "
            f"{res['ckpt_bytes']} bytes, snapshot {res['snapshot_s']:.2f} "
            f"s, write {res['write_s']:.2f} s")
    return res


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
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--data", default=None,
                    help="flat binary int32 token file (io.TokenFeed, "
                         "C++ prefetch); default: synthetic random ids")
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
    if args.data:
        source = TokenFeed(args.data, sample_elems=seq + 1,
                           batch_size=args.batch, dtype=np.int32, seed=0)
    else:
        source = synthetic_batches(cfg.vocab_size, args.batch, seq,
                                   seed=args.seed + 1)
    return train(model, args.steps, args.batch, seq, lr=args.lr,
                 use_amp=args.amp, source=source,
                 log=lambda s: print(s, flush=True), compiled=True,
                 ckpt_dir=args.ckpt_dir, resume=args.resume)


if __name__ == "__main__":
    main()
