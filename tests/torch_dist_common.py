"""Shared by the multi-rank parity tests: the reference's side of the
inputs (weights, batches), and the gloo worlds that run the port's side
(``tests/torch_dist_worker.py``), one world per (size, unit) a session.

A world's ranks are separate processes over a ``FileStore`` in a
session directory (no port: xdist workers' worlds never collide). Every
rank joins within the worker's ``JOIN_TIMEOUT_S`` (60 s) and each is
waited for at most ``WORLD_TIMEOUT_S``: a hung collective fails its tests, the processes
killed. Under xdist the first worker to ask for a world runs it under a
file lock and the others read its results.
"""

import os
import pickle
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_dist_worker.py")
WORLD_TIMEOUT_S = 120

#: the tiny Llama of the sharded-training cases: 2 layers, 4 heads over
#: 2 kv heads (tp 2 takes one kv head a rank), batch 4 x 16 tokens
LLAMA_CFG = dict(num_hidden_layers=2)
LLAMA_MOE_CFG = dict(num_hidden_layers=2, moe_num_experts=4, moe_top_k=2)
LLAMA_BATCH, LLAMA_SEQ, LLAMA_STEPS = 4, 16, 3
IGNORED = 5         # labels at ignore_index in the first row of a batch


def state_arrays(layer):
    return {k: np.asarray(v._data) for k, v in layer.state_dict().items()}


def reference_llama(moe, seed=0):
    import paddle_tpu as paddle
    from paddle_tpu.models import LlamaForCausalLM, tiny_llama_config
    paddle.seed(seed)
    return LlamaForCausalLM(tiny_llama_config(
        **(LLAMA_MOE_CFG if moe else LLAMA_CFG)))


def llama_batches():
    """``(ids, labels)`` of each step; the first row's first labels are
    ``ignore_index``, so the batch ranks hold unequal counts of rows."""
    rng = np.random.RandomState(11)
    out = []
    for _ in range(LLAMA_STEPS):
        ids = rng.randint(0, 128, (LLAMA_BATCH, LLAMA_SEQ + 1)) \
            .astype(np.int64)
        labels = ids[:, 1:].copy()
        labels[0, :IGNORED] = -100
        out.append((np.ascontiguousarray(ids[:, :-1]), labels))
    return out


def make_inputs(world, unit):
    """The numpy inputs both sides share: seeded data and the reference
    layers' weights (its layout; the port's loader transposes)."""
    import paddle_tpu as paddle
    import paddle_tpu.distributed as dist
    from paddle_tpu.distributed import ProcessMesh
    rng = np.random.RandomState(0)
    inp = {}
    if unit == "llama" or world == 2:
        inp["llama_cfg"] = LLAMA_CFG
        inp["llama_moe_cfg"] = LLAMA_MOE_CFG
        inp["llama_w"] = state_arrays(reference_llama(False))
        inp["llama_moe_w"] = state_arrays(reference_llama(True))
        inp["llama_batches"] = llama_batches()
    if unit != "core":
        return inp
    mesh = mp_mesh(world)
    inp["api_x"] = rng.randn(8, 16).astype(np.float32)
    paddle.seed(3)
    lin = paddle.nn.Linear(16, 32)
    inp["opt_w"] = np.asarray(lin.weight._data)
    inp["opt_b"] = np.asarray(lin.bias._data)
    for name, make, x in mp_layer_specs(mesh, rng):
        inp[f"mp_{name}_w"] = state_arrays(make())
        inp[f"mp_{name}_x"] = x
    paddle.seed(11)
    inp["mp_pair_col_w"] = state_arrays(dist.ColumnParallelLinear(
        16, 64, mesh, gather_output=False))
    inp["mp_pair_row_w"] = state_arrays(dist.RowParallelLinear(
        64, 16, mesh, input_is_parallel=True))
    inp["mp_pair_x"] = rng.randn(4, 16).astype(np.float32)
    sp_mesh = ProcessMesh(np.arange(world), ["mp"])
    paddle.seed(2)
    inp["mp_sp_col_w"] = state_arrays(dist.ColumnSequenceParallelLinear(
        16, 32, sp_mesh, has_bias=False))
    inp["mp_sp_row_w"] = state_arrays(dist.RowSequenceParallelLinear(
        32, 16, sp_mesh, has_bias=False))
    inp["mp_sp_x3"] = rng.randn(2, 8, 16).astype(np.float32)
    inp["mp_sp_x2"] = rng.randn(16, 16).astype(np.float32)
    inp["pce_logits"] = rng.randn(12, 64).astype(np.float32)
    labels = rng.randint(0, 64, (12,)).astype(np.int64)
    labels[3] = -100
    inp["pce_labels"] = labels
    paddle.seed(5)
    inp["pce_head_w"] = state_arrays(dist.ColumnParallelLinear(
        16, 64, mesh, has_bias=False, gather_output=False))
    inp["pce_hidden"] = rng.randn(12, 16).astype(np.float32)
    if world == 4:
        inp["dp_x"] = rng.randn(8, 4).astype(np.float32)
        inp["dp_y"] = rng.randn(8, 1).astype(np.float32)
        paddle.seed(5)
        inp["dp_w"] = state_arrays(paddle.nn.Linear(4, 1))
        inp["moe_x"] = rng.randn(16, 8).astype(np.float32)
        from paddle_tpu.incubate.moe import MoELayer
        paddle.seed(8)
        inp["moe_w"] = state_arrays(MoELayer(8, 16, num_experts=8,
                                             capacity_factor=1.0))
    return inp


def mp_mesh(world):
    from paddle_tpu.distributed import ProcessMesh
    if world == 4:
        return ProcessMesh(np.arange(4).reshape(2, 2), ["dp", "mp"])
    return ProcessMesh(np.arange(world), ["mp"])


def mp_layer_specs(mesh, rng):
    """``(name, make reference layer, input)`` of the single mp layers."""
    import paddle_tpu as paddle
    import paddle_tpu.distributed as dist

    def seeded(seed, ctor):
        def make():
            paddle.seed(seed)
            return ctor()
        return make
    return [
        ("column", seeded(7, lambda: dist.ColumnParallelLinear(16, 32, mesh)),
         rng.randn(4, 16).astype(np.float32)),
        ("row", seeded(7, lambda: dist.RowParallelLinear(32, 16, mesh)),
         rng.randn(4, 32).astype(np.float32)),
        ("vocab_embedding",
         seeded(3, lambda: dist.VocabParallelEmbedding(64, 16, mesh)),
         np.array([[1, 5, 63], [0, 2, 40]], np.int64)),
    ]


def _run_world(world, unit, out_dir, inputs=None):
    if inputs is None:
        inputs = make_inputs(world, unit)
    with open(os.path.join(out_dir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    store = os.path.join(out_dir, "store")
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JAX_PLATFORMS", "XLA_FLAGS")}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    logs = [open(os.path.join(out_dir, f"rank{r}.log"), "w")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(world), unit, str(r), store, out_dir],
        cwd=out_dir, env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(world)]
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    results, errors = [], []
    for r, p in enumerate(procs):
        path = os.path.join(out_dir, f"rank{r}.pkl")
        if p.returncode != 0 or not os.path.exists(path):
            with open(os.path.join(out_dir, f"rank{r}.log")) as f:
                errors.append(f"rank {r} exit {p.returncode}:\n"
                              f"{f.read()[-4000:]}")
            continue
        with open(path, "rb") as f:
            results.append(pickle.load(f))
    return {"results": results, "errors": errors}


def _session():
    """This test session's id, the same in each of its xdist workers."""
    return os.environ.get("PYTEST_XDIST_TESTRUNUID") or f"pid{os.getpid()}"


def _world_dir(tmp_path_factory, world, unit):
    """The world's directory in this session's own temporary directory:
    under xdist, the parent that the session's workers share; without
    it, the base itself (its parent outlives every session)."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    root = base / f"torch_dist_{world}_{unit}"
    root.mkdir(parents=True, exist_ok=True)
    return root


def _load_own(done):
    """The results in ``done`` if this session wrote them, else None."""
    if not done.exists():
        return None
    with open(done, "rb") as f:
        res = pickle.load(f)
    return res if res.get("session") == _session() else None


def start_worlds(tmp_path_factory, worlds):
    """Start running each ``(world, unit)`` of ``worlds`` on a thread of
    this process, so the reference's side of the tests computes while the
    port's ranks run; :func:`world_results` then waits for them. The
    inputs are made here first: the reference's random stream is global,
    and the tests draw from it meanwhile."""
    import threading
    for world, unit in worlds:
        root = _world_dir(tmp_path_factory, world, unit)
        if _load_own(root / "results.pkl") is not None:
            continue
        args = (root, world, unit, make_inputs(world, unit))
        threading.Thread(target=_ensure_world, args=args, daemon=True,
                         name=f"torch_dist_{world}_{unit}").start()


def _ensure_world(root, world, unit, inputs=None):
    """Run the world once (under a file lock across xdist workers) unless
    this session's results are on disk; returns them."""
    from filelock import FileLock
    done = root / "results.pkl"
    # a world's holder is bounded by WORLD_TIMEOUT_S; a waiter by thrice it
    with FileLock(str(root) + ".lock", timeout=3 * WORLD_TIMEOUT_S):
        res = _load_own(done)
        if res is None:
            res = _run_world(world, unit, str(root), inputs)
            res["session"] = _session()
            with open(done, "wb") as f:
                pickle.dump(res, f)
    return res


def world_results(tmp_path_factory, world, unit):
    """Every rank's ``{case: result}`` of the port's world of ``world``
    ranks running ``unit``: run once a session (across xdist workers),
    cached on disk. Raises with the ranks' logs if any rank failed."""
    res = _ensure_world(_world_dir(tmp_path_factory, world, unit), world,
                        unit)
    if res["errors"]:
        raise AssertionError("the port's world failed:\n"
                             + "\n".join(res["errors"]))
    return res["results"]
