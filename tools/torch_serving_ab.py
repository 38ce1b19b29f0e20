#!/usr/bin/env python3
"""Serving throughput of two or more checkouts of ``paddle_tpu_torch`` on
one card, in alternating order.

    python3 tools/torch_serving_ab.py TREE [TREE ...] [--rounds N]
        [--reps K] [--model llama3-8b|mixtral-int8] [--out PATH]

Each TREE is the root of a checkout holding ``chip_smoke.py`` and
``paddle_tpu_torch/``. A round runs the trees in the given order and then
in reverse (A B B A for two trees), each in a process of its own that
imports that tree's code: it builds the tree's ``chip_smoke.py`` phase 4
workload (``serving_workload``: Llama-3-8B at full width and depth, random
bf16 weights from a seeded generator on the card, ``max_batch=8``,
``page_size=16``) or, with ``--model mixtral-int8``, phase 6's
(``mixtral_int8``: Mixtral-8x7B at full width and depth with int8 weights,
the same engine geometry), serves the 8 prompts of 64-512 tokens once to warm up,
then ``--reps`` times more, 32 new tokens each, and reports the tokens/s
of each pass (new tokens over the wall time of ``generate``, synchronised,
as phase 4 reads it). Prints one JSON object with every reading, by tree
and in run order; ``--out`` also writes it to a file. Needs one card.
"""

import argparse
import json
import os
import subprocess
import sys
import time


def child(reps, model):
    """One process's readings for the tree it runs in: a JSON line."""
    sys.path.insert(0, os.getcwd())
    import torch
    import chip_smoke as cs
    from paddle_tpu_torch.inference import LlamaServingEngine, Request
    NEW = cs.NEW
    dev = torch.device("cuda")
    if model == "mixtral-int8":
        moe = cs.mixtral_int8(dev)
        engine = LlamaServingEngine(moe, max_batch=8, page_size=16,
                                    weight_dtype="int8")
        prompts = cs.serving_prompts(moe.config.vocab_size)
    else:
        _, _, engine, prompts = cs.serving_workload(dev)

    def run():
        reqs = [Request(p, max_new_tokens=NEW) for p in prompts]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.generate(reqs)
        torch.cuda.synchronize()
        return len(prompts) * NEW / (time.perf_counter() - t0)
    run()                                        # warm-up
    print(json.dumps({"tokens_per_s": [run() for _ in range(reps)]}))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--model", choices=("llama3-8b", "mixtral-int8"),
                    default="llama3-8b")
    ap.add_argument("--out", default="")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.reps, args.model)
        return
    if not args.trees:
        ap.error("name at least one tree")
    trees = [os.path.abspath(t) for t in args.trees]
    order = [t for _ in range(args.rounds) for t in trees + trees[::-1]]
    runs = []
    for tree in order:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", "--reps",
             str(args.reps), "--model", args.model], cwd=tree,
            capture_output=True, text=True)
        if res.returncode != 0:
            sys.stderr.write(res.stdout + res.stderr)
            sys.exit(f"the run in {tree} failed ({res.returncode})")
        reading = json.loads(res.stdout.strip().splitlines()[-1])
        runs.append({"tree": tree, **reading})
        print(f"{tree}: tokens_per_s={reading['tokens_per_s']}", flush=True)
    by_tree = {t: [x for r in runs if r["tree"] == t
                   for x in r["tokens_per_s"]] for t in trees}
    text = json.dumps({"runs": runs, "tokens_per_s_by_tree": by_tree},
                      indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)


if __name__ == "__main__":
    main()
