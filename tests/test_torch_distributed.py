"""The port's distributed layer against the reference, rank by rank.

The reference runs as ``tests/test_distributed.py`` runs it:
``shard_map`` / GSPMD over the virtual CPU devices ``tests/conftest.py``
sets up, on meshes of 2, 4 and 2 x 2 devices. The port runs gloo worlds
of the same sizes (``tests/torch_dist_common.py``: one world per size
and unit a session, each rank its own process over a ``FileStore``, a
120 s bound on every world); rank ``i``'s result is held against device
``i``'s. Values are exact where both sides move the same numbers, else
within 1e-5 relative (f32 sums in other orders).

Stated differences, each held here: ``send`` / ``recv`` raise on both
sides; ``ProcessMesh.to_jax_mesh`` is ``to_device_mesh``; a
``torch.nn.Linear`` weight is ``[out, in]``, so its shard dims are the
reference's swapped; ``ReduceOp.PROD`` and explicit rank groups have no
``shard_map`` form in the reference, so they are held against the
reduction they name; multi-rank runs are checked on the CPU (gloo) only,
the card's run being a world of one over NCCL.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec
try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

import paddle_tpu as paddle
import paddle_tpu.distributed as rdist
from paddle_tpu.distributed import ProcessMesh as RMesh

import paddle_tpu_torch.distributed as pdist
from paddle_tpu_torch.distributed import fleet as pfleet

from torch_dist_common import (start_worlds, make_inputs, mp_layer_specs, mp_mesh,
                               world_results)

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _worlds(tmp_path_factory):
    """The port's worlds start first and run beside the reference."""
    start_worlds(tmp_path_factory, ((2, "core"), (4, "core"), (4, "llama")))

RTOL = 1e-5


def _ranks(tmp_path_factory, world, unit="core"):
    return world_results(tmp_path_factory, world, unit)


def _mesh_of(world):
    if world == 4:
        return RMesh(np.arange(4).reshape(2, 2), ["dp", "mp"])
    return RMesh(np.arange(world), ["mp"])


def _per_device(mesh, bodies, *inputs):
    """``bodies`` (name -> body of the inputs) under one ``shard_map``
    over ``mesh`` (every axis splits dim 0 of each input): name -> device
    ``i``'s output, one program for them all."""
    axes = tuple(mesh.dim_names)
    spec = PartitionSpec(axes)
    names = list(bodies)
    f = shard_map(lambda *xs: tuple(bodies[n](*xs) for n in names),
                  mesh=mesh.to_jax_mesh(), in_specs=(spec,) * len(inputs),
                  out_specs=tuple(spec for _ in names))
    outs = f(*[jnp.asarray(a) for a in inputs])
    n = len(mesh.process_ids)
    return {name: np.split(np.asarray(o), n) for name, o in zip(names, outs)}


def _t(x):
    return paddle.Tensor(x)


# -- the collectives: the reference's per-device outputs ----------------------
def _ref_collectives(world):
    mesh = _mesh_of(world)
    n_mp = mesh.get_dim_size("mp")
    v = np.arange(world, dtype=np.float32) + 1          # rank i holds i + 1
    r = np.arange(world, dtype=np.float32)
    bodies = {}
    for name, op in (("sum", rdist.ReduceOp.SUM), ("max", rdist.ReduceOp.MAX),
                     ("min", rdist.ReduceOp.MIN), ("avg", rdist.ReduceOp.AVG)):
        bodies[f"all_reduce_{name}"] = \
            lambda x, rk, op=op: rdist.all_reduce(_t(x), op=op,
                                                  group="mp")._data
    bodies["all_reduce_group"] = lambda x, rk: rdist.all_reduce(
        _t(x), group=rdist.new_group(axis_name="mp"))._data
    if world == 4:
        bodies["all_reduce_dp"] = \
            lambda x, rk: rdist.all_reduce(_t(x), group="dp")._data

    def gather(x, rk):
        lst = []
        rdist.all_gather(lst, _t(x), group="mp")
        return jnp.stack([t._data for t in lst]).reshape(-1)
    bodies["all_gather"] = gather

    def rs(x, rk):
        got = paddle.zeros([1])
        rdist.reduce_scatter(got, _t(jnp.arange(n_mp, dtype=jnp.float32)
                                     * x[0]), group="mp")
        return got._data.reshape(1)
    bodies["reduce_scatter"] = rs

    def rs_list(x, rk):
        got = paddle.zeros([1])
        rdist.reduce_scatter(got, [_t(x * (j + 1)) for j in range(n_mp)],
                             group="mp")
        return got._data.reshape(1)
    bodies["reduce_scatter_list"] = rs_list

    def a2a(x, rk):
        res = []
        rdist.alltoall(res, [_t(10 * rk + j) for j in range(n_mp)],
                       group="mp")
        return jnp.concatenate([t._data for t in res])
    bodies["alltoall"] = a2a
    bodies["broadcast"] = \
        lambda x, rk: rdist.broadcast(_t(x), src=1, group="mp")._data
    bodies["reduce"] = \
        lambda x, rk: rdist.reduce(_t(x), dst=0, group="mp")._data

    def scat(x, rk):
        got = paddle.zeros([1])
        rdist.scatter(got, [_t(10 * rk + j) for j in range(n_mp)], src=1,
                      group="mp")
        return got._data.reshape(1)
    bodies["scatter"] = scat
    bodies["wait"] = lambda x, rk: rdist.wait(_t(x))._data
    bodies["axis_rank"] = lambda x, rk: jnp.full(
        (1,), rdist.p2p.axis_rank("mp"), jnp.float32)
    bodies["axis_size"] = lambda x, rk: jnp.full(
        (1,), rdist.p2p.axis_size("mp"), jnp.float32)
    out = _per_device(mesh, bodies, v, r)
    for key in ("all_gather", "alltoall"):
        out[key] = [a.reshape(n_mp, 1) for a in out[key]]
    perm = [(0, world - 1), (world - 1, 1)] if world > 2 else [(0, 1)]
    out.update(_per_device(RMesh(np.arange(world), ["x"]), {
        "shift_wrap": lambda x: rdist.p2p.shift(x, "x", offset=1, wrap=True),
        "shift_back_wrap":
            lambda x: rdist.p2p.shift(x, "x", offset=-1, wrap=True),
        "send_forward": lambda x: rdist.p2p.send_forward(x, "x"),
        "send_backward": lambda x: rdist.p2p.send_backward(x, "x"),
        "ppermute": lambda x: rdist.p2p.ppermute(x, "x", perm)}, v))
    return out


_REF_COLLECTIVES = {}


def ref_collectives(world):
    if world not in _REF_COLLECTIVES:
        _REF_COLLECTIVES[world] = _ref_collectives(world)
    return _REF_COLLECTIVES[world]


COLLECTIVES = ["all_reduce_sum", "all_reduce_max", "all_reduce_min",
               "all_reduce_avg", "all_reduce_group", "all_gather",
               "reduce_scatter", "reduce_scatter_list", "alltoall",
               "broadcast", "reduce", "scatter", "wait", "shift_wrap",
               "shift_back_wrap", "send_forward", "send_backward",
               "ppermute"]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", COLLECTIVES)
def test_collective_rank_by_rank(tmp_path_factory, world, case):
    want = ref_collectives(world)[case]
    got = _ranks(tmp_path_factory, world)
    assert len(got) == world
    for rank in range(world):
        np.testing.assert_allclose(got[rank][case], want[rank], rtol=RTOL,
                                   err_msg=f"{case} rank {rank}")


def test_all_reduce_over_dp_rank_by_rank(tmp_path_factory):
    want = ref_collectives(4)["all_reduce_dp"]
    for rank, res in enumerate(_ranks(tmp_path_factory, 4)):
        np.testing.assert_allclose(res["all_reduce_dp"], want[rank])


@pytest.mark.parametrize("world", [2, 4])
def test_reductions_without_a_shard_map_form(tmp_path_factory, world):
    """PROD and explicit rank lists (the reference's shard_map has neither)
    give the reduction they name: the product over the rank's mp group,
    and the mp axis's sum over a group made of the same ranks."""
    sums = ref_collectives(world)["all_reduce_sum"]
    mesh = _mesh_of(world)
    n_mp = mesh.get_dim_size("mp")
    for rank, res in enumerate(_ranks(tmp_path_factory, world)):
        first = rank - rank % n_mp
        want = np.prod(np.arange(first, first + n_mp) + 1.0)
        np.testing.assert_allclose(res["all_reduce_prod"], [want])
        np.testing.assert_allclose(res["all_reduce_ranks"], sums[rank])


@pytest.mark.parametrize("world", [2, 4])
def test_axis_queries_and_objects(tmp_path_factory, world):
    ref = ref_collectives(world)
    n_mp = _mesh_of(world).get_dim_size("mp")
    for rank, res in enumerate(_ranks(tmp_path_factory, world)):
        a_rank, a_size, g_rank, g_size, mp_rank, mp_size = res["axis"]
        assert a_rank == int(ref["axis_rank"][rank][0])
        assert a_size == int(ref["axis_size"][rank][0]) == n_mp
        assert (g_rank, g_size) == (rank, world)
        assert (mp_rank, mp_size) == (a_rank, a_size)
        first = rank - rank % n_mp
        assert res["all_gather_object"] == list(range(first, first + n_mp))


def test_send_recv_raise_as_the_reference():
    for name in ("send", "recv", "isend", "irecv"):
        with pytest.raises(NotImplementedError):
            getattr(rdist, name)(paddle.ones([1]))
        with pytest.raises(NotImplementedError, match="p2p"):
            getattr(pdist, name)(torch.ones(1))


def test_no_world_is_the_reference_eager_identity():
    """With no process group each collective returns what the reference
    returns eagerly, and the environment is one rank."""
    assert not torch.distributed.is_initialized()
    assert (pdist.get_rank(), pdist.get_world_size()) == (0, 1)
    assert not pdist.is_initialized()
    x = torch.tensor([3.0])
    assert pdist.all_reduce(x) is x
    lst = []
    assert pdist.all_gather(lst, x) is x and lst == [x]
    objs = []
    pdist.all_gather_object(objs, "a")
    assert objs == ["a"]
    assert pdist.broadcast(x, src=0) is x and pdist.reduce(x) is x
    out = []
    assert torch.equal(pdist.alltoall(out, [x, x]), torch.stack([x, x]))
    assert out == [x, x]
    got = torch.zeros(1)
    pdist.reduce_scatter(got, [x * 2])
    assert torch.equal(got, x * 2)
    pdist.scatter(got, [x])
    assert torch.equal(got, x)
    pdist.barrier()
    assert pdist.p2p.axis_size("x") == 1 and pdist.p2p.axis_rank("x") == 0
    assert torch.equal(pdist.p2p.shift(x, "x", wrap=True), x)
    assert torch.equal(pdist.p2p.send_forward(x, "x"), torch.zeros(1))


def test_single_process_defaults():
    """The reference's ``test_single_process_defaults``: the port starts a
    world of one (an in-process store, gloo on the CPU; NCCL would serve
    the card) and reports rank 0 of 1."""
    from paddle_tpu_torch.distributed import env
    assert env.backend_for("cuda") == "nccl"
    assert env.backend_for("cpu") == "gloo"
    rdist.init_parallel_env()
    try:
        e = pdist.init_parallel_env(device="cpu")
        assert torch.distributed.get_backend() == "gloo"
        assert (pdist.get_rank(), pdist.get_world_size()) == \
            (rdist.get_rank(), rdist.get_world_size()) == (0, 1)
        assert e.nranks == rdist.ParallelEnv().nranks == 1
        assert pdist.is_initialized()
        assert pdist.init_parallel_env(device="cpu").world_size == 1
    finally:
        torch.distributed.destroy_process_group()


# -- meshes and placements -----------------------------------------------------
def test_process_mesh_metadata_matches():
    ids = np.arange(8).reshape(2, 4)
    r, p = RMesh(ids, ["dp", "mp"]), pdist.ProcessMesh(ids, ["dp", "mp"])
    assert (p.shape, p.ndim, p.dim_names, p.process_ids) == \
        (r.shape, r.ndim, r.dim_names, r.process_ids)
    assert p.get_dim_size("mp") == r.get_dim_size("mp") == 4
    for pid in range(8):
        for axis in ("dp", "mp"):
            assert p.get_rank_by_dim_and_process_id(axis, pid) == \
                r.get_rank_by_dim_and_process_id(axis, pid)
    assert p == pdist.ProcessMesh(ids, ["dp", "mp"])
    assert hash(p) == hash(pdist.ProcessMesh(ids, ["dp", "mp"]))
    assert p != pdist.ProcessMesh(ids.reshape(4, 2), ["dp", "mp"])
    m = pdist.init_mesh((2, 2, 2), ["pp", "dp", "mp"])
    assert m.shape == rdist.init_mesh((2, 2, 2), ["pp", "dp", "mp"]).shape
    with pytest.raises(TypeError):
        pdist.ProcessMesh(np.zeros(2), ["x"])
    with pytest.raises(ValueError):
        pdist.ProcessMesh(ids, ["x"])


def test_to_jax_mesh_is_to_device_mesh():
    """The reference's ``to_jax_mesh`` is ``to_device_mesh`` in the port
    (a torch ``DeviceMesh``, which needs a started world)."""
    p = pdist.ProcessMesh(np.arange(2), ["x"])
    assert hasattr(RMesh, "to_jax_mesh") and not hasattr(p, "to_jax_mesh")
    with pytest.raises(RuntimeError, match="init_parallel_env"):
        p.to_device_mesh()


@pytest.mark.parametrize("ndim,placements", [
    (2, ("S0", "R")), (2, ("S0", "S1")), (2, ("S1", "S1")),
    (3, ("R", "R")), (2, ("R", "S1"))])
def test_to_partition_spec_matches(ndim, placements):
    def make(mod, code):
        return mod.Replicate() if code == "R" else mod.Shard(int(code[1]))
    ids = np.arange(8).reshape(2, 4)
    want = rdist.to_partition_spec(ndim, RMesh(ids, ["dp", "mp"]),
                                   [make(rdist, c) for c in placements])
    got = pdist.to_partition_spec(ndim, pdist.ProcessMesh(ids, ["dp", "mp"]),
                                  [make(pdist, c) for c in placements])
    assert got == tuple(want)


def test_to_partition_spec_rejects_as_the_reference():
    m = pdist.ProcessMesh(np.arange(8).reshape(2, 4), ["dp", "mp"])
    with pytest.raises(ValueError):
        pdist.to_partition_spec(2, m, [pdist.Shard(0)])
    with pytest.raises(ValueError):
        pdist.to_partition_spec(1, m, [pdist.Shard(3), pdist.Replicate()])


def test_placements_convert_to_torch():
    from paddle_tpu_torch.distributed import placement as pl
    ours = [pdist.Shard(1), pdist.Replicate(), pdist.Partial("avg")]
    assert pl.from_torch(pl.to_torch(ours)) == ours
    assert pdist.Shard(1).is_shard(1) and not pdist.Shard(1).is_shard(0)
    assert pdist.Partial().is_partial() and pdist.Replicate().is_replicated()


def _ref_shards(arr):
    return {s.device.id: np.asarray(s.data) for s in arr.addressable_shards}


def test_shard_tensor_and_reshard_rank_by_rank(tmp_path_factory):
    x = make_inputs(4, "core")["api_x"]
    m = _mesh_of(4)
    xs = rdist.shard_tensor(paddle.to_tensor(x), m,
                            [rdist.Shard(0), rdist.Shard(1)])
    want = _ref_shards(xs._data)
    xr = rdist.reshard(
        rdist.shard_tensor(paddle.to_tensor(x), m,
                           [rdist.Shard(0), rdist.Replicate()]),
        m, [rdist.Replicate(), rdist.Shard(0)])
    want_r = _ref_shards(xr._data)
    for rank, res in enumerate(_ranks(tmp_path_factory, 4)):
        local, shape, annotated = res["shard_tensor"]
        np.testing.assert_array_equal(local, want[rank])
        assert shape == (8, 16) and annotated
        local, full = res["reshard"]
        np.testing.assert_array_equal(local, want_r[rank])
        np.testing.assert_array_equal(full, x)
        np.testing.assert_array_equal(res["unshard"], x)
        assert res["dtensor_from_fn"] == ((4, 4), (4, 4))
        assert res["partial_refused"]


def test_grad_flows_through_a_placed_parameter(tmp_path_factory):
    m = _mesh_of(4)
    w = paddle.framework.Parameter(jnp.ones((8, 8), jnp.float32))
    ws = rdist.shard_tensor(w, m, [rdist.Replicate(), rdist.Shard(0)])
    paddle.matmul(paddle.ones([2, 8]), ws).sum().backward()
    for res in _ranks(tmp_path_factory, 4):
        np.testing.assert_allclose(res["grad_through_shard"],
                                   np.asarray(ws.grad._data))


@pytest.mark.parametrize("override", [False, True])
def test_shard_optimizer_rank_by_rank(tmp_path_factory, override):
    """Adam's moments take the parameter's layout (or the ``shard_fn``'s
    replacement) and the two steps' values are the reference's (the
    reference's weight ``[in, out]`` placed ``Shard(1)`` is the port's
    ``[out, in]`` on ``Shard(0)``)."""
    inp = make_inputs(4, "core")
    m = _mesh_of(4)
    lin = paddle.nn.Linear(16, 32)
    lin.weight = rdist.shard_tensor(
        paddle.to_tensor(inp["opt_w"]), m,
        [rdist.Replicate(), rdist.Shard(1)])
    lin.weight.stop_gradient = False
    lin.bias.set_value(inp["opt_b"])

    def shard_fn(name, param, acc):
        if name == "moment1" and tuple(acc.shape) == (16, 32):
            return rdist.shard_tensor(acc, m, [rdist.Replicate()] * 2)
        return None
    opt = rdist.shard_optimizer(
        paddle.optimizer.Adam(parameters=[lin.weight, lin.bias]),
        shard_fn if override else None)
    for _ in range(2):
        lin(paddle.ones([4, 16])).sum().backward()
        opt.step()
        opt.clear_grad()
    m1 = opt._get_accumulator("moment1", lin.weight)
    key = "shard_optimizer_fn" if override else "shard_optimizer"
    for res in _ranks(tmp_path_factory, 4):
        m1_same, m2_same, m1_val, w_val, seen = res[key]
        assert m1_same == (not override) and m2_same
        assert seen == override
        np.testing.assert_allclose(m1_val.T, np.asarray(m1._data),
                                   rtol=RTOL, atol=1e-7)
        np.testing.assert_allclose(w_val.T, np.asarray(lin.weight._data),
                                   rtol=RTOL, atol=1e-7)


def test_optimizer_state_of_a_placed_parameter_is_placed(tmp_path_factory):
    """Without ``shard_optimizer`` too: the port's optimizers make each
    state tensor of a placed parameter in its layout."""
    for res in _ranks(tmp_path_factory, 4, "llama"):
        for name, value in res.items():
            if name.startswith("llama_") and not name.endswith("_kernels"):
                assert value[2]      # every parameter placed


# -- the tensor-parallel layers ------------------------------------------------
def _ref_layer_grads(layer, transpose=()):
    return {k: (np.asarray(p.grad._data).T if k in transpose
                else np.asarray(p.grad._data))
            for k, p in layer.named_parameters()}


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6, err_msg=what)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["column", "row", "vocab_embedding"])
def test_mp_layer_rank_by_rank(tmp_path_factory, world, name):
    mesh = mp_mesh(world)
    inp = make_inputs(world, "core")
    spec = {n: (make, x) for n, make, x in
            mp_layer_specs(mesh, np.random.RandomState(0))}
    make, _ = spec[name]
    layer = make()
    y = layer(paddle.to_tensor(inp[f"mp_{name}_x"]))
    y.sum().backward()
    want = _ref_layer_grads(layer, transpose={"linear.weight"})
    for rank, res in enumerate(_ranks(tmp_path_factory, world)):
        out, grads = res[name]
        _close(out, np.asarray(y._data), f"{name} out rank {rank}")
        assert set(grads) == set(want)
        for k in want:
            _close(grads[k], want[k], f"{name} {k} grad rank {rank}")


@pytest.mark.parametrize("world", [2, 4])
def test_megatron_pair_rank_by_rank(tmp_path_factory, world):
    mesh = mp_mesh(world)
    inp = make_inputs(world, "core")
    paddle.seed(11)
    col = rdist.ColumnParallelLinear(16, 64, mesh, gather_output=False)
    row = rdist.RowParallelLinear(64, 16, mesh, input_is_parallel=True)
    y = row(paddle.nn.functional.relu(col(paddle.to_tensor(
        inp["mp_pair_x"]))))
    y.sum().backward()
    for rank, res in enumerate(_ranks(tmp_path_factory, world)):
        out, gcol, grow = res["megatron_pair"]
        _close(out, np.asarray(y._data), f"pair out rank {rank}")
        _close(gcol.T, np.asarray(col.linear.weight.grad._data), "col grad")
        _close(grow.T, np.asarray(row.linear.weight.grad._data), "row grad")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("layout", ["sp_3d", "sp_2d"])
def test_sequence_parallel_pair_rank_by_rank(tmp_path_factory, world,
                                             layout):
    inp = make_inputs(world, "core")
    mesh = RMesh(np.arange(world), ["mp"])
    paddle.seed(2)
    col = rdist.ColumnSequenceParallelLinear(16, 32, mesh, has_bias=False)
    row = rdist.RowSequenceParallelLinear(32, 16, mesh, has_bias=False)
    x = inp["mp_sp_x3" if layout == "sp_3d" else "mp_sp_x2"]
    sd = 1 if x.ndim == 3 else 0
    xs = rdist.shard_tensor(paddle.to_tensor(x), mesh, [rdist.Shard(sd)])
    y = row(col(xs).relu())
    (y ** 2).mean().backward()
    assert y._data.sharding.spec[sd] == "mp"
    for rank, res in enumerate(_ranks(tmp_path_factory, world)):
        out, seq_sharded, gcol, grow = res[layout]
        assert seq_sharded
        _close(out, np.asarray(y._data), f"{layout} out rank {rank}")
        _close(gcol.T, np.asarray(col.linear.weight.grad._data), "col grad")
        _close(grow.T, np.asarray(row.linear.weight.grad._data), "row grad")


@pytest.mark.parametrize("world", [2, 4])
def test_parallel_cross_entropy_rank_by_rank(tmp_path_factory, world):
    """Vocab-sharded logits, and the lm head's shard through the loss
    kernel's merge, against the reference's layer on the same logits."""
    inp = make_inputs(world, "core")
    mesh = mp_mesh(world)
    labels = paddle.to_tensor(inp["pce_labels"])
    ce = rdist.ParallelCrossEntropy(mesh)
    logits = paddle.to_tensor(inp["pce_logits"])
    logits.stop_gradient = False
    nll = ce(logits, labels)
    nll.sum().backward()
    paddle.seed(5)
    head = rdist.ColumnParallelLinear(16, 64, mesh, has_bias=False,
                                      gather_output=False)
    h = paddle.to_tensor(inp["pce_hidden"])
    h.stop_gradient = False
    nll_h = ce(head(h), labels)
    nll_h.sum().backward()
    for rank, res in enumerate(_ranks(tmp_path_factory, world)):
        got, glogits = res["parallel_ce_logits"]
        _close(got.reshape(-1), np.asarray(nll._data).reshape(-1), "nll")
        _close(glogits, np.asarray(logits.grad._data), "logits grad")
        got, gh, gw = res["parallel_ce_head"]
        _close(got.reshape(-1), np.asarray(nll_h._data).reshape(-1),
               "head nll")
        _close(gh, np.asarray(h.grad._data), "hidden grad")
        _close(gw.T, np.asarray(head.linear.weight.grad._data), "head grad")


def test_linear_layout_swaps_the_shard_dims():
    """A column-parallel weight is ``Shard(1)`` of ``[in, out]`` in the
    reference and ``Shard(0)`` of ``[out, in]`` here; a row-parallel one
    the other way round (the mp layers' docstring)."""
    from paddle_tpu_torch.distributed import mp_layers
    doc = mp_layers.__doc__
    assert "[out, in]" in doc and "swap" in doc
    mesh = RMesh(np.arange(2), ["mp"])
    col = rdist.ColumnParallelLinear(4, 8, mesh)
    row = rdist.RowParallelLinear(8, 4, mesh)
    assert col.linear.weight._data.sharding.spec[1] == "mp"
    assert row.linear.weight._data.sharding.spec[0] == "mp"
    assert mp_layers._placements(pdist.ProcessMesh(np.arange(2), ["mp"]),
                                 0, 0) == [pdist.Shard(0)]


# -- DataParallel, shard_dataloader and fleet ----------------------------------
def test_dp_matches_single_device_rank_by_rank(tmp_path_factory):
    """The reference's ``test_dp_matches_single_device`` on 4 devices: the
    port's 4 ranks report the reference's losses, which are the single
    device's, and end on its weight: each gradient summed over dp once."""
    inp = make_inputs(4, "core")
    x, y = paddle.to_tensor(inp["dp_x"]), paddle.to_tensor(inp["dp_y"])

    def train(dp):
        paddle.seed(5)
        m = paddle.nn.Linear(4, 1)
        model = rdist.DataParallel(
            m, mesh=RMesh(np.arange(4), ["dp"])) if dp else m
        opt = paddle.optimizer.SGD(learning_rate=0.1,
                                   parameters=model.parameters())
        losses = []
        for _ in range(4):
            loss = ((model(x) - y) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
        return losses, np.asarray(m.weight._data)
    want, w = train(True)
    single, _ = train(False)
    np.testing.assert_allclose(want, single, rtol=RTOL)
    for res in _ranks(tmp_path_factory, 4):
        np.testing.assert_allclose(res["dp_losses"], want, rtol=RTOL)
        np.testing.assert_allclose(res["dp_weight"].T, w, rtol=RTOL,
                                   atol=1e-7)


def test_shard_dataloader_rank_by_rank(tmp_path_factory):
    from paddle_tpu.io import DataLoader, TensorDataset
    xs = paddle.to_tensor(np.arange(64, dtype=np.float32).reshape(32, 2))
    dl = DataLoader(TensorDataset([xs]), batch_size=8)
    mesh = RMesh(np.arange(4), ["dp"])
    want = [_ref_shards(b[0]._data)
            for b in rdist.shard_dataloader(dl, mesh, shard_dims="dp")]
    for rank, res in enumerate(_ranks(tmp_path_factory, 4)):
        got = res["shard_dataloader"]
        assert len(got) == len(want) == 4
        for (n, local), shards in zip(got, want):
            assert n == 4
            np.testing.assert_array_equal(local, shards[rank])


def test_build_topology_matches():
    for cfg, world in (({"mp_degree": 4, "dp_degree": 2}, 8),
                       ({"mp_degree": 2}, 8), ({"mp_degree": 2}, 4),
                       ({}, 1)):
        rs, ps = rdist.fleet.DistributedStrategy(), \
            pfleet.DistributedStrategy()
        rs.hybrid_configs.update(cfg)
        ps.hybrid_configs.update(cfg)
        r = rdist.fleet.build_topology(rs, world_size=world)
        p = pfleet.build_topology(ps, world_size=world)
        assert (p.dim_names, p.shape, p.process_ids) == \
            (r.dim_names, r.shape, r.process_ids)
    ps = pfleet.DistributedStrategy()
    ps.hybrid_configs.update({"mp_degree": 3})
    with pytest.raises(ValueError):
        pfleet.build_topology(ps, world_size=8)


def test_fleet_ranks_rank_by_rank(tmp_path_factory):
    s = rdist.fleet.DistributedStrategy()
    s.hybrid_configs.update({"mp_degree": 2, "dp_degree": 2})
    mesh = rdist.fleet.build_topology(s, world_size=4)
    for rank, res in enumerate(_ranks(tmp_path_factory, 4)):
        (names, shape, dp_rank, mp_rank, dp_size, mp_size, index, num,
         first, worker) = res["fleet"]
        assert (names, shape) == (mesh.dim_names, mesh.shape)
        assert dp_rank == mesh.get_rank_by_dim_and_process_id("dp", rank)
        assert mp_rank == mesh.get_rank_by_dim_and_process_id("mp", rank)
        assert (dp_size, mp_size) == (2, 2)
        assert (index, num, first, worker) == (rank, 4, rank == 0, True)
        assert res["fleet_model"] == "DataParallel"


def test_fleet_module_level_api_without_a_world():
    """The delegates exist as in the reference; with no world the
    hybrid group answers rank 0 of one."""
    for name in ("init", "distributed_model", "distributed_optimizer",
                 "get_hybrid_communicate_group", "worker_index", "worker_num",
                 "is_first_worker", "is_worker", "barrier_worker",
                 "PaddleCloudRoleMaker", "UserDefinedRoleMaker", "utils",
                 "recompute"):
        assert hasattr(pfleet, name) and hasattr(rdist.fleet, name), name
    hcg = pfleet.HybridCommunicateGroup(pfleet.build_topology(world_size=1))
    assert hcg.get_data_parallel_rank() == 0
    assert hcg.get_model_parallel_world_size() == 1
    assert hcg.get_data_parallel_group() is None
    assert pfleet.PaddleCloudRoleMaker(is_collective=True).is_collective


# -- expert parallelism in MoELayer --------------------------------------------
@pytest.mark.parametrize("mode", ["ragged", "dense"])
def test_moe_layer_ep_rank_by_rank(tmp_path_factory, mode):
    """``MoELayer(mesh=)`` over 4 ep ranks (2 experts each) against the
    reference's over 4 devices: the output, ``l_aux``, ``dropped`` and
    every gradient (each rank's experts through the grouped GEMM in the
    ragged dispatch)."""
    from paddle_tpu.incubate.moe import MoELayer
    inp = make_inputs(4, "core")
    paddle.seed(8)
    moe = MoELayer(8, 16, num_experts=8, mesh=RMesh(np.arange(4), ["ep"]),
                   capacity_factor=1.0, dispatch_mode=mode)
    y = moe(paddle.to_tensor(inp["moe_x"]))
    (y ** 2).mean().backward()
    want = _ref_layer_grads(moe)
    for rank, res in enumerate(_ranks(tmp_path_factory, 4)):
        out, l_aux, dropped, grads, local_w1 = res[f"moe_{mode}"]
        _close(out, np.asarray(y._data), f"moe out rank {rank}")
        np.testing.assert_allclose(l_aux, float(moe.l_aux), rtol=RTOL)
        assert dropped == int(np.asarray(moe.build_fn(16)(
            *[t._data for t in (paddle.to_tensor(inp["moe_x"]),
                                moe.gate_weight, moe.w1, moe.b1, moe.w2,
                                moe.b2)])[2]))
        assert local_w1 == (2, 8, 16)
        for k in want:
            _close(grads[k], want[k], f"moe {k} grad rank {rank}")
