#!/usr/bin/env python3
"""Serving throughput of two or more checkouts of ``paddle_tpu_torch`` on
one card, in alternating order.

    python3 tools/torch_serving_ab.py TREE [TREE ...] [--rounds N]
        [--reps K] [--model llama3-8b|mixtral-int8]
        [--engines E[,E...]] [--metrics on|off|on,off] [--out PATH]

Each TREE is the root of a checkout holding ``chip_smoke.py`` and
``paddle_tpu_torch/``. A round runs the trees in the given order and then
in reverse (A B B A for two trees), each in a process of its own that
imports that tree's code: it builds the tree's ``chip_smoke.py`` phase 4
model (``llama_model``: Llama-3-8B at full width and depth, random bf16
weights from a seeded generator on the card) or, with ``--model
mixtral-int8``, phase 6's (``mixtral_int8``: Mixtral-8x7B at full width
and depth with int8 weights), and behind it, one after another, each
engine of ``--engines`` (default ``bf16-graphed``): ``max_batch=8``,
``page_size=16``, the prefix cache off, ``bf16`` or ``int8kv`` (phase 8's
int8 KV) pools, ``graphed`` (the default decode scans) or ``single``
(``decode_ticks=1``). Each engine is warmed up as the smoke warms it,
serves the 8 prompts of 64-512 tokens once more, then ``--reps`` times,
32 new tokens each, and reports the tokens/s of each pass (new tokens
over the wall time of ``generate``, synchronised, as phase 4 reads it).
Then one more pass, timed apart and never counted in tokens/s, reads the
mean mixed and decode-only dispatch ms and graphed tick ms (synchronised
around each, as phase 4 reads them) and the host ms that each of the request lifecycle's
steps took, summed over the pass, where the tree has them
(``_expire_deadlines``, ``_pump_requeue``, ``_relieve_pressure``,
``_flush_deferred``, ``_arm_watchdog``, ``_disarm_watchdog``, and the
metric calls ``_set_pool_gauges``, ``_note_perf``, ``_note_mixed_bytes``,
``_record_shape``), with the pass's count of mixed dispatches and scans.
``--metrics on,off`` runs every tree twice a round, with
``PADDLE_TPU_METRICS=1`` and ``=0`` (the second half of a round in the
reverse order: A-on A-off B-on B-off B-off B-on A-off A-on for two
trees), so the host cost of the metrics reads within one call, on the
parent and on the change; readings are keyed
``TREE:on`` / ``TREE:off``. Prints the card's name and power limit
first, then one JSON object with every reading (the card's too), by tree
(and mode) and in run order; ``--out`` also writes it to a file. Needs
one card.
"""

import argparse
import json
import os
import subprocess
import sys
import time


ENGINES = {"bf16-graphed": (None, None), "bf16-single": (None, 1),
           "int8kv-graphed": ("int8", None), "int8kv-single": ("int8", 1)}
LIFECYCLE = ("_expire_deadlines", "_pump_requeue", "_relieve_pressure",
             "_flush_deferred", "_arm_watchdog", "_disarm_watchdog",
             # the engine's metric calls apart from its inline counters
             "_set_pool_gauges", "_note_perf", "_note_mixed_bytes",
             "_record_shape")


def instrumented(engine, run):
    """One pass of ``run`` with the engine's mixed dispatches and scans
    timed (synchronised) and its lifecycle steps' host time summed."""
    import torch
    spent = {k: 0.0 for k in LIFECYCLE if hasattr(engine, k)}
    times, ticks = {"mixed": [], "decode": []}, []
    dispatch, scan = engine._dispatch_rows, engine._decode_scan

    def timer(name, fn):
        def wrapped(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[name] += time.perf_counter() - t0
        return wrapped

    def timed_dispatch(rows, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = dispatch(rows, *a)
        torch.cuda.synchronize()
        mixed = any(n > 1 or not dec for _, _, _, n, _, dec in rows)
        times["mixed" if mixed else "decode"].append(
            time.perf_counter() - t0)
        return out

    def timed_scan(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = scan(n)
        torch.cuda.synchronize()
        if out:
            ticks.append((time.perf_counter() - t0, n))
        return out
    patches = {k: timer(k, getattr(engine, k)) for k in spent}
    patches.update(_dispatch_rows=timed_dispatch, _decode_scan=timed_scan)
    for k, v in patches.items():
        setattr(engine, k, v)
    try:
        run()
    finally:
        for k in patches:
            delattr(engine, k)
    n_ticks = sum(n for _, n in ticks)
    mean_ms = {k: 1e3 * sum(v) / max(len(v), 1) for k, v in times.items()}
    return {"mixed_dispatch_ms": mean_ms["mixed"],
            "decode_dispatch_ms": mean_ms["decode"],
            "tick_ms": 1e3 * sum(t for t, _ in ticks) / max(n_ticks, 1),
            "dispatches": sum(map(len, times.values())),
            "scans": len(ticks),
            "lifecycle_host_ms": {k: 1e3 * v for k, v in spent.items()}}


def child(reps, model, engines):
    """One process's readings for the tree it runs in: a JSON line."""
    sys.path.insert(0, os.getcwd())
    import torch
    import chip_smoke as cs
    from paddle_tpu_torch.inference import Request
    NEW = cs.NEW
    dev = torch.device("cuda")
    if model == "mixtral-int8":
        net = cs.mixtral_int8(dev)
        weight_dtype = "int8"
    else:
        _, net = cs.llama_model(dev)
        weight_dtype = None
    prompts = cs.serving_prompts(net.config.vocab_size)
    out = {"tokens_per_s": {}, "pass": {}}
    for name in engines:
        kv_dtype, ticks = ENGINES[name]
        engine = cs.serving_engine(net, kv_dtype, 16, weight_dtype, ticks)
        cs.warm_up(engine, prompts)

        def run():
            reqs = [Request(p, max_new_tokens=NEW) for p in prompts]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.generate(reqs)
            torch.cuda.synchronize()
            return len(prompts) * NEW / (time.perf_counter() - t0)
        run()                                        # warm-up
        out["tokens_per_s"][name] = [run() for _ in range(reps)]
        out["pass"][name] = instrumented(engine, run)
        del engine
        torch.cuda.empty_cache()
    print(json.dumps(out))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--model", choices=("llama3-8b", "mixtral-int8"),
                    default="llama3-8b")
    ap.add_argument("--engines", default="bf16-graphed",
                    help=f"comma-separated, of {sorted(ENGINES)}")
    ap.add_argument("--metrics", default="on",
                    help="on, off or on,off: PADDLE_TPU_METRICS per run")
    ap.add_argument("--out", default="")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    engines = args.engines.split(",")
    for name in engines:
        if name not in ENGINES:
            ap.error(f"unknown engine {name!r}; one of {sorted(ENGINES)}")
    if args.child:
        child(args.reps, args.model, engines)
        return
    if not args.trees:
        ap.error("name at least one tree")
    modes = args.metrics.split(",")
    for m in modes:
        if m not in ("on", "off"):
            ap.error(f"--metrics takes on, off or on,off, not {m!r}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    trees = [os.path.abspath(t) for t in args.trees]
    half = [(t, m) for t in trees for m in modes]
    order = [x for _ in range(args.rounds) for x in half + half[::-1]]
    runs = []
    for tree, mode in order:
        env = dict(os.environ, PADDLE_TPU_METRICS="1" if mode == "on"
                   else "0")
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", "--reps",
             str(args.reps), "--model", args.model, "--engines",
             args.engines], cwd=tree, env=env,
            capture_output=True, text=True)
        if res.returncode != 0:
            sys.stderr.write(res.stdout + res.stderr)
            sys.exit(f"the run in {tree} failed ({res.returncode})")
        reading = json.loads(res.stdout.strip().splitlines()[-1])
        runs.append({"tree": tree, "metrics": mode, **reading})
        print(f"{tree} metrics={mode}: tokens_per_s="
              f"{reading['tokens_per_s']}", flush=True)
    keys = [(t, m) for t in trees for m in modes]
    name = (lambda t, m: t) if len(modes) == 1 else \
        (lambda t, m: f"{t}:{m}")
    by_tree = {name(t, m): {e: [x for r in runs if r["tree"] == t
                                and r["metrics"] == m
                                for x in r["tokens_per_s"][e]]
                            for e in engines} for t, m in keys}
    text = json.dumps({"card": card, "runs": runs,
                       "tokens_per_s_by_tree": by_tree}, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)


if __name__ == "__main__":
    main()
