"""One rank of a gloo world running the port's side of the multi-rank
parity tests (``tests/test_torch_distributed.py``,
``tests/test_torch_parallel_llama.py``).

Run as ``python tests/torch_dist_worker.py WORLD UNIT RANK STORE_FILE
OUT_DIR``: the rank joins the world over a ``FileStore`` (no port, so
worlds of concurrent test workers never collide), reads the inputs the
test wrote to ``OUT_DIR/inputs.pkl`` (reference weights and batches as
numpy arrays), runs every case of its world and unit (:data:`CASES`),
and pickles ``{case: result}`` to ``OUT_DIR/rank<R>.pkl``. It imports
torch and the port only.
"""

import datetime
import os
import pickle
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
torch.set_num_threads(1)

JOIN_TIMEOUT_S = 60

#: AdamW of the Llama cases, the same on both sides
LR, WD = 1e-3, 0.1


def _t(*vals):
    return torch.tensor(vals, dtype=torch.float32)


def _np(t):
    if type(t).__name__ == "DTensor":
        t = t.full_tensor()
    return t.detach().cpu().numpy()


# -- the collectives and p2p, rank by rank ------------------------------------
def collective_cases(world):
    import paddle_tpu_torch.distributed as pd
    from paddle_tpu_torch.distributed import ProcessMesh, p2p
    rank = dist.get_rank()
    out = {}
    if world == 4:
        mesh = ProcessMesh(np.arange(4).reshape(2, 2), ["dp", "mp"])
    else:
        mesh = ProcessMesh(np.arange(world), ["mp"])
    ring = ProcessMesh(np.arange(world), ["x"])
    pd.set_mesh(mesh)
    mesh.to_device_mesh()
    ring.to_device_mesh()
    v = float(rank + 1)
    for name, op in (("sum", pd.ReduceOp.SUM), ("max", pd.ReduceOp.MAX),
                     ("min", pd.ReduceOp.MIN), ("prod", pd.ReduceOp.PROD),
                     ("avg", pd.ReduceOp.AVG)):
        out[f"all_reduce_{name}"] = _np(pd.all_reduce(_t(v), op=op,
                                                      group="mp"))
    out["all_reduce_group"] = _np(pd.all_reduce(
        _t(v), group=pd.new_group(axis_name="mp")))
    # explicit rank lists: every rank creates every group, in one order
    n_mp = mesh.get_dim_size("mp")
    groups = [pd.new_group(list(range(i, i + n_mp)))
              for i in range(0, world, n_mp)]
    out["all_reduce_ranks"] = _np(pd.all_reduce(
        _t(v), group=groups[rank // n_mp]))
    lst = []
    stacked = pd.all_gather(lst, _t(v), group="mp")
    out["all_gather"] = _np(torch.stack(lst))
    assert torch.equal(stacked, torch.stack(lst))
    got = torch.zeros(1)
    pd.reduce_scatter(got, torch.arange(n_mp, dtype=torch.float32) * v,
                      group="mp")
    out["reduce_scatter"] = _np(got)
    got = torch.zeros(1)
    pd.reduce_scatter(got, [_t(v * (j + 1)) for j in range(n_mp)],
                      group="mp")
    out["reduce_scatter_list"] = _np(got)
    res = []
    pd.alltoall(res, [_t(10 * rank + j) for j in range(n_mp)], group="mp")
    out["alltoall"] = _np(torch.stack(res))
    out["broadcast"] = _np(pd.broadcast(_t(v), src=1, group="mp"))
    out["reduce"] = _np(pd.reduce(_t(v), dst=0, group="mp"))
    got = torch.zeros(1)
    pd.scatter(got, [_t(10 * rank + j) for j in range(n_mp)], src=1,
               group="mp")
    out["scatter"] = _np(got)
    objs = []
    pd.all_gather_object(objs, {"rank": rank}, group="mp")
    out["all_gather_object"] = [o["rank"] for o in objs]
    pd.barrier(group="mp")
    pd.barrier()
    out["wait"] = _np(pd.wait(_t(v)))
    if world == 4:
        out["all_reduce_dp"] = _np(pd.all_reduce(_t(v), group="dp"))
    pd.set_mesh(ring)
    x = _t(v)
    out["shift_wrap"] = _np(p2p.shift(x, "x", offset=1, wrap=True))
    out["shift_back_wrap"] = _np(p2p.shift(x, "x", offset=-1, wrap=True))
    out["send_forward"] = _np(p2p.send_forward(x, "x"))
    out["send_backward"] = _np(p2p.send_backward(x, "x"))
    perm = [(0, world - 1), (world - 1, 1)] if world > 2 else [(0, 1)]
    out["ppermute"] = _np(p2p.ppermute(x, "x", perm))
    pd.set_mesh(mesh)
    out["axis"] = [p2p.axis_rank("mp"), p2p.axis_size("mp"),
                   pd.get_rank(), pd.get_world_size(),
                   pd.get_rank("mp"), pd.get_world_size("mp")]
    pd.set_mesh(None)
    return out


# -- placements ----------------------------------------------------------------
def api_cases(world, inputs):
    import paddle_tpu_torch.distributed as pd
    from paddle_tpu_torch.distributed import (Partial, ProcessMesh,
                                              Replicate, Shard)
    from paddle_tpu_torch.optimizer import Adam
    mesh = ProcessMesh(np.arange(4).reshape(2, 2), ["dp", "mp"])
    x = torch.from_numpy(inputs["api_x"])
    out = {}
    xs = pd.shard_tensor(x, mesh, [Shard(0), Shard(1)])
    out["shard_tensor"] = (xs.to_local().numpy(), tuple(xs.shape),
                           xs._placements == [Shard(0), Shard(1)])
    xs = pd.shard_tensor(x, mesh, [Shard(0), Replicate()])
    xr = pd.reshard(xs, mesh, [Replicate(), Shard(0)])
    out["reshard"] = (xr.to_local().numpy(), _np(xr))
    out["unshard"] = pd.unshard_dtensor(xs).numpy()
    d = pd.dtensor_from_fn(torch.zeros, mesh, [Replicate(), Replicate()],
                           [4, 4])
    out["dtensor_from_fn"] = (tuple(d.shape), tuple(d.to_local().shape))
    try:
        pd.shard_tensor(torch.ones(4), mesh, [Partial(), Replicate()])
        out["partial_refused"] = False
    except ValueError:
        out["partial_refused"] = True
    # the gradient flows back through a placed parameter
    w = torch.nn.Parameter(torch.ones(8, 8))
    ws = pd.shard_tensor(w, mesh, [Replicate(), Shard(0)])
    ones = pd.shard_tensor(torch.ones(2, 8), mesh,
                           [Replicate(), Replicate()])
    torch.matmul(ones, ws).sum().backward()
    out["grad_through_shard"] = _np(ws.grad)
    # shard_optimizer: the reference's Linear(16, 32) weight [in, out]
    # placed [Replicate, Shard(1)] is the port's [out, in] on Shard(0)
    for key, override in (("shard_optimizer", False),
                          ("shard_optimizer_fn", True)):
        lin = torch.nn.Linear(16, 32)
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(inputs["opt_w"].T))
            lin.bias.copy_(torch.from_numpy(inputs["opt_b"]))
        lin.weight = pd.shard_tensor(lin.weight, mesh,
                                     [Replicate(), Shard(0)])
        lin.bias = pd.shard_tensor(lin.bias, mesh,
                                   [Replicate(), Replicate()])
        seen = []

        def shard_fn(name, param, acc):
            seen.append((name, tuple(param.shape)))
            if name == "moment1" and tuple(acc.shape) == (32, 16):
                return pd.shard_tensor(acc, mesh, [Replicate(), Replicate()])
            return None
        opt = pd.shard_optimizer(Adam(parameters=[lin.weight, lin.bias]),
                                 shard_fn if override else None)
        wrapped = opt._add_accumulator
        assert pd.shard_optimizer(opt) is opt
        assert opt._add_accumulator is wrapped
        opt._shard_fn = shard_fn if override else None
        xin = pd.shard_tensor(torch.ones(4, 16), mesh,
                              [Replicate(), Replicate()])
        for _ in range(2):
            torch.nn.functional.linear(xin, lin.weight, lin.bias).sum() \
                .backward()
            opt.step()
            opt.clear_grad()
        m1 = opt._get_accumulator("moment1", lin.weight)
        m2 = opt._get_accumulator("moment2", lin.weight)
        out[key] = (tuple(m1.placements) == tuple(lin.weight.placements),
                    tuple(m2.placements) == tuple(lin.weight.placements),
                    _np(m1), _np(lin.weight), ("moment1", (32, 16)) in seen)
    return out


# -- the tensor-parallel layers ------------------------------------------------
def _fill(layer, arrays):
    from paddle_tpu_torch.models import load_numpy_state
    return load_numpy_state(layer, arrays)


def mp_layer_cases(world, inputs):
    import paddle_tpu_torch.distributed as pd
    from paddle_tpu_torch.distributed import ProcessMesh, Shard
    if world == 4:
        mesh = ProcessMesh(np.arange(4).reshape(2, 2), ["dp", "mp"])
    else:
        mesh = ProcessMesh(np.arange(world), ["mp"])
    out = {}
    make = {
        "column": lambda: pd.ColumnParallelLinear(16, 32, mesh),
        "row": lambda: pd.RowParallelLinear(32, 16, mesh),
        "vocab_embedding": lambda: pd.VocabParallelEmbedding(64, 16, mesh),
    }
    for name, ctor in make.items():
        layer = _fill(ctor(), inputs[f"mp_{name}_w"])
        x = torch.from_numpy(inputs[f"mp_{name}_x"])
        y = layer(x)
        y.sum().backward()
        out[name] = (_np(y), {k: _np(p.grad)
                              for k, p in layer.named_parameters()})
    # the Megatron pair: column (output left sharded) -> relu -> row
    col = _fill(pd.ColumnParallelLinear(16, 64, mesh, gather_output=False),
                inputs["mp_pair_col_w"])
    row = _fill(pd.RowParallelLinear(64, 16, mesh, input_is_parallel=True),
                inputs["mp_pair_row_w"])
    y = row(torch.relu(col(torch.from_numpy(inputs["mp_pair_x"]))))
    y.sum().backward()
    out["megatron_pair"] = (_np(y), _np(col.linear.weight.grad),
                            _np(row.linear.weight.grad))
    # the sequence-parallel pair on a sequence-sharded input
    for key, xin in (("sp_3d", "mp_sp_x3"), ("sp_2d", "mp_sp_x2")):
        col = _fill(pd.ColumnSequenceParallelLinear(16, 32, mesh,
                                                    has_bias=False),
                    inputs["mp_sp_col_w"])
        row = _fill(pd.RowSequenceParallelLinear(32, 16, mesh,
                                                 has_bias=False),
                    inputs["mp_sp_row_w"])
        x = torch.from_numpy(inputs[xin])
        sd = 1 if x.dim() == 3 else 0
        place = [pd.Replicate()] * mesh.ndim
        place[mesh.dim_names.index("mp")] = Shard(sd)
        xs = pd.shard_tensor(x, mesh, place)
        y = row(torch.relu(col(xs)))
        seq_sharded = y.placements[mesh.dim_names.index("mp")].is_shard(sd)
        (y.full_tensor() ** 2).mean().backward()
        out[key] = (_np(y), seq_sharded, _np(col.linear.weight.grad),
                    _np(row.linear.weight.grad))
    # ParallelCrossEntropy: vocab-sharded logits, and the lm head's shard
    # through the loss kernel's merge
    logits = torch.from_numpy(inputs["pce_logits"]).requires_grad_()
    labels = torch.from_numpy(inputs["pce_labels"])
    pce = pd.ParallelCrossEntropy(mesh=mesh)
    nll = pce(logits, labels)
    nll.sum().backward()
    out["parallel_ce_logits"] = (_np(nll), _np(logits.grad))
    head = _fill(pd.ColumnParallelLinear(16, 64, mesh, has_bias=False,
                                         gather_output=False),
                 inputs["pce_head_w"])
    h = torch.from_numpy(inputs["pce_hidden"]).requires_grad_()
    nll = pce(h, labels, weight=head.linear.weight)
    nll.sum().backward()
    out["parallel_ce_head"] = (_np(nll), _np(h.grad),
                               _np(head.linear.weight.grad))
    return out


# -- DataParallel and fleet ----------------------------------------------------
def dp_cases(world, inputs):
    import paddle_tpu_torch.distributed as pd
    from paddle_tpu_torch.distributed import ProcessMesh, fleet
    from paddle_tpu_torch.optimizer import SGD
    out = {}
    x = torch.from_numpy(inputs["dp_x"])
    y = torch.from_numpy(inputs["dp_y"])
    lin = _fill(torch.nn.Linear(4, 1), inputs["dp_w"])
    model = pd.DataParallel(lin, mesh=ProcessMesh(np.arange(world), ["dp"]))
    opt = SGD(learning_rate=0.1, parameters=model.parameters())
    losses = []
    for _ in range(4):
        loss = ((model(x) - y) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    out["dp_losses"] = losses
    out["dp_weight"] = _np(lin.weight)
    from paddle_tpu_torch.io import DataLoader, TensorDataset
    dl = DataLoader(TensorDataset([torch.arange(64, dtype=torch.float32)
                                   .reshape(32, 2)]), batch_size=8)
    loader = pd.shard_dataloader(dl, ProcessMesh(np.arange(world), ["dp"]),
                                 shard_dims="dp")
    out["shard_dataloader"] = [
        (len(loader), b[0].to_local().numpy()) for b in loader]
    s = fleet.DistributedStrategy()
    s.hybrid_configs.update({"mp_degree": 2, "dp_degree": world // 2})
    f = fleet.init(strategy=s, device="cpu")
    hcg = f.get_hybrid_communicate_group()
    out["fleet"] = (f.mesh().dim_names, f.mesh().shape,
                    hcg.get_data_parallel_rank(),
                    hcg.get_model_parallel_rank(),
                    hcg.get_data_parallel_world_size(),
                    hcg.get_model_parallel_world_size(),
                    fleet.worker_index(), fleet.worker_num(),
                    fleet.is_first_worker(), fleet.is_worker())
    wrapped = fleet.distributed_model(torch.nn.Linear(4, 2))
    out["fleet_model"] = type(wrapped).__name__
    fleet.barrier_worker()
    pd.set_mesh(None)
    return out


# -- MoELayer over an ep mesh --------------------------------------------------
def moe_layer_cases(world, inputs):
    from paddle_tpu_torch.distributed import ProcessMesh
    from paddle_tpu_torch.incubate.moe import MoELayer
    mesh = ProcessMesh(np.arange(world), ["ep"])
    out = {}
    x = torch.from_numpy(inputs["moe_x"])
    for mode in ("ragged", "dense"):
        moe = MoELayer(8, 16, num_experts=8, mesh=mesh, capacity_factor=1.0,
                       dispatch_mode=mode, device="cpu")
        _fill(moe, inputs["moe_w"])
        y = moe(x)
        (y ** 2).mean().backward()
        out[f"moe_{mode}"] = (_np(y), float(moe.l_aux), int(moe.dropped),
                              {k: _np(p.grad)
                               for k, p in moe.named_parameters()},
                              tuple(moe.w1.to_local().shape))
    return out


# -- the sharded Llama ---------------------------------------------------------
LLAMA_MESHES = {
    2: {"tp2": (["mp"], [2], dict(tp_axis="mp"))},
    4: {"dp2_mp2": (["dp", "mp"], [2, 2], dict(tp_axis="mp")),
        "fsdp4": (["fsdp"], [4], dict(tp_axis=None, fsdp_axis="fsdp")),
        "dp2_ep2": (["dp", "ep"], [2, 2], dict(tp_axis=None,
                                               ep_axis="ep"))},
}


def llama_cases(world, inputs):
    """Each mesh of :data:`LLAMA_MESHES`, and the loss kernel's and the
    grouped GEMM's weight operands as the layers hand them over (the
    kernels' own wrappers on the card; their plain versions here)."""
    from paddle_tpu_torch.models import llama as L
    from paddle_tpu_torch.ops import fused_linear_cross_entropy as FC
    out = {}
    seen = []
    parts, grouped = FC._parts, L.grouped_gemm

    def parts_spy(h2d, w, labels, chunk):
        seen.append(("loss", tuple(w.shape)))
        return parts(h2d, w, labels, chunk)

    def grouped_spy(x, w, gs):
        seen.append(("grouped", tuple(w.shape)))
        return grouped(x, w, gs)
    FC._parts, L.grouped_gemm = parts_spy, grouped_spy
    try:
        for name, (names, shape, kw) in LLAMA_MESHES[world].items():
            seen.clear()
            out.update(_llama_case(name, names, shape, kw, world, inputs))
            out[f"llama_{name}_kernels"] = sorted(set(seen))
    finally:
        FC._parts, L.grouped_gemm = parts, grouped
    if world == 2:
        out["llama_tp2_generate"] = _placed_generate(world, inputs)
    return out


def _placed_generate(world, inputs):
    """Greedy ``generate`` of the tiny Llama unplaced and placed at tp 2
    (the KV cache of each rank's heads): both token lists."""
    from paddle_tpu_torch.distributed import ProcessMesh
    from paddle_tpu_torch.models import (LlamaForCausalLM, shard_llama,
                                         tiny_llama_config)
    ids = torch.from_numpy(inputs["llama_batches"][0][0][:2, :8])
    outs = []
    for placed in (False, True):
        model = _fill(LlamaForCausalLM(tiny_llama_config(
            **inputs["llama_cfg"]), device="cpu"), inputs["llama_w"])
        if placed:
            shard_llama(model, ProcessMesh(np.arange(world), ["mp"]))
        outs.append(model.generate(ids, max_new_tokens=4).numpy())
    return outs


def _llama_case(name, names, shape, kw, world, inputs):
    """Three AdamW steps of the tiny Llama placed by ``shard_llama`` on
    one mesh: the global batch's losses, the attention's local head
    counts, every parameter's placements."""
    from paddle_tpu_torch.distributed import ProcessMesh
    from paddle_tpu_torch.models import (LlamaForCausalLM, shard_llama,
                                         tiny_llama_config)
    from paddle_tpu_torch.optimizer import AdamW
    moe = "ep_axis" in kw
    cfg = tiny_llama_config(**inputs["llama_moe_cfg" if moe
                                     else "llama_cfg"])
    model = _fill(LlamaForCausalLM(cfg, device="cpu"),
                  inputs["llama_moe_w" if moe else "llama_w"])
    mesh = ProcessMesh(np.arange(world).reshape(shape), names)
    shard_llama(model, mesh, **kw)
    plan = model.plan
    a = model.model.layers[0].self_attn
    opt = AdamW(learning_rate=LR, weight_decay=WD,
                parameters=model.named_parameters())
    index, count = plan.batch_slice()
    losses = []
    for ids, labels in inputs["llama_batches"]:
        per = ids.shape[0] // count
        rows = slice(index * per, (index + 1) * per)
        loss, _ = model(torch.from_numpy(ids[rows]),
                        torch.from_numpy(labels[rows]))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(plan.mean_over_batch(loss)))
    placements = {k: tuple(str(pl) for pl in p.placements)
                  for k, p in model.named_parameters()}
    return {f"llama_{name}": (losses, (a.num_heads, a.num_kv_heads),
                              placements)}


# -- the recipe under a mesh ---------------------------------------------------
def recipe_cases(world, inputs):
    from paddle_tpu_torch.examples import llama_pretrain
    out = {}
    base = ["--config", "tiny", "--device", "cpu", "--steps", "3",
            "--batch", "4"]
    runs = {"recipe_single": base,
            "recipe_mesh": base + ["--mesh", "2x2"],
            "recipe_fsdp": base + ["--mesh", "fsdp"],
            "recipe_moe_single": base + ["--moe", "4"],
            "recipe_moe_ep": base + ["--mesh", "2x2", "--moe", "4", "--ep"]}
    for name, argv in runs.items():
        res = llama_pretrain.main(argv)
        out[name] = res["losses"]
    return out


#: the cases each world runs: (world size, unit) -> case functions
CASES = {
    (2, "core"): (collective_cases, mp_layer_cases, llama_cases),
    (4, "core"): (collective_cases, api_cases, mp_layer_cases, dp_cases,
                  moe_layer_cases),
    (4, "llama"): (llama_cases, recipe_cases),
}


def main():
    # below the suite's own processes: a busy world must not starve the
    # timing-bound tests running beside it
    os.nice(10)
    world, unit, rank, store, out_dir = (int(sys.argv[1]), sys.argv[2],
                                         int(sys.argv[3]), sys.argv[4],
                                         sys.argv[5])
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=JOIN_TIMEOUT_S))
    with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    results = {}
    try:
        for fn in CASES[world, unit]:
            args = (world,) if fn is collective_cases else (world, inputs)
            results.update(fn(*args))
    except Exception:
        results["error"] = traceback.format_exc()
        raise
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
