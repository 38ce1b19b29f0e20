"""The slice as a whole: the tiny Llama (2 layers, 4 heads over 2 kv
heads, vocab 128) placed by ``shard_llama`` and trained three AdamW steps
(lr 1e-3, weight decay 0.1) on batches of 4 x 16 tokens, the port's
gloo world against the reference's GSPMD mesh of as many devices: tp 2
(a world of 2), dp 2 x mp 2, fsdp 4 and the MoE (4 experts, top 2) at dp
2 x ep 2 (worlds of 4). The weights are the reference model's, carried
across by ``models/convert.py`` before the placement. The first row of
each batch has 5 labels at ``ignore_index``, so the dp ranks hold unequal
counts of rows. Each step's loss (the global batch's mean over its valid
rows) is held to 1e-5 relative, f32 on both sides.

Also the recipe under a mesh (``--mesh 2x2``, ``--mesh fsdp``, ``--mesh
2x2 --moe 4 --ep``) against the same recipe on one device, and the
stated difference: the port's loss kernel (#5) and grouped GEMM (#6)
take each rank's shard (its vocab rows, its experts), where the
reference demotes a sharded operand to its XLA formulation.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import ProcessMesh as RMesh
from paddle_tpu.models import shard_llama as ref_shard_llama

from paddle_tpu_torch.distributed import ProcessMesh
from paddle_tpu_torch.examples import llama_pretrain
from paddle_tpu_torch.models import (LlamaForCausalLM, shard_llama,
                                     tiny_llama_config)

from torch_dist_common import (start_worlds, LLAMA_CFG, LLAMA_MOE_CFG, llama_batches,
                               reference_llama, world_results)

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _worlds(tmp_path_factory):
    """The port's worlds start first and run beside the reference."""
    start_worlds(tmp_path_factory, ((2, "core"), (4, "llama")))

LR, WD = 1e-3, 0.1
RTOL = 1e-5

#: name -> (world, mesh axes, mesh shape, shard_llama's axes)
MESHES = {
    "tp2": (2, ["mp"], [2], dict(tp_axis="mp")),
    "dp2_mp2": (4, ["dp", "mp"], [2, 2], dict(tp_axis="mp")),
    "fsdp4": (4, ["fsdp"], [4], dict(tp_axis=None, fsdp_axis="fsdp")),
    "dp2_ep2": (4, ["dp", "ep"], [2, 2], dict(tp_axis=None, ep_axis="ep")),
}


def _port_results(tmp_path_factory, world):
    return world_results(tmp_path_factory, world,
                         "core" if world == 2 else "llama")


def _reference_run(name):
    world, names, shape, kw = MESHES[name]
    moe = "ep_axis" in kw
    model = reference_llama(moe)
    mesh = RMesh(np.arange(world).reshape(shape), names)
    ref_shard_llama(model, mesh, **kw)
    opt = paddle.optimizer.AdamW(learning_rate=LR, weight_decay=WD,
                                 parameters=model.parameters())

    def step(ids, labels):
        loss, _ = model(ids, labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    # the reference's compiled step (its first call eager), a quarter of
    # its eager steps' time under GSPMD
    step = paddle.jit.to_static(step, state=[model, opt])
    losses = [float(step(paddle.to_tensor(ids), paddle.to_tensor(labels)))
              for ids, labels in llama_batches()]
    return model, losses


@pytest.mark.parametrize("name", list(MESHES))
def test_sharded_losses_match_reference(tmp_path_factory, name):
    model, want = _reference_run(name)
    world, names, shape, kw = MESHES[name]
    tp = shape[names.index("mp")] if kw.get("tp_axis") else 1
    ranks = _port_results(tmp_path_factory, world)
    assert len(ranks) == world
    for rank, res in enumerate(ranks):
        losses, heads, _ = res[f"llama_{name}"]
        np.testing.assert_allclose(losses, want, rtol=RTOL, atol=0,
                                   err_msg=f"{name} rank {rank}")
        cfg = model.config
        assert heads == (cfg.num_attention_heads // tp,
                         cfg.num_key_value_heads // tp)


@pytest.mark.parametrize("name", list(MESHES))
def test_placements_are_the_references(tmp_path_factory, name):
    """Every parameter's placement is the reference's, a linear weight's
    tensor dims swapped (``[out, in]`` against ``[in, out]``)."""
    from paddle_tpu_torch.distributed.mp_layers import ShardedLinear
    world, names, shape, kw = MESHES[name]
    moe = "ep_axis" in kw
    ref = reference_llama(moe)
    ref_shard_llama(ref, RMesh(np.arange(world).reshape(shape), names),
                    **kw)
    specs = {k: tuple(v._data.sharding.spec)
             for k, v in ref.state_dict().items()}
    port = LlamaForCausalLM(tiny_llama_config(
        **(LLAMA_MOE_CFG if moe else LLAMA_CFG)), device="meta")
    linear = {n + ".weight" for n, m in port.named_modules()
              if isinstance(m, (torch.nn.Linear, ShardedLinear))}
    placements = _port_results(tmp_path_factory, world)[0][
        f"llama_{name}"][2]
    assert set(placements) == set(specs)
    for key, pl in placements.items():
        spec = list(specs[key]) + [None] * (3 - len(specs[key]))
        if key in linear:
            spec = [spec[1], spec[0], spec[2]]
        for axis, p in zip(names, pl):
            if p.startswith("S("):                     # torch's Shard
                assert spec[int(p[2:-1])] == axis, (key, pl, specs[key])
            else:
                assert axis not in spec, (key, pl, specs[key])


def test_kernels_take_each_ranks_shard(tmp_path_factory):
    """The stated difference: the port hands the loss kernel each rank's
    vocab shard of the lm head under tp (all of it, gathered, under fsdp)
    and the grouped GEMM each rank's experts under ep; the reference
    demotes its sharded experts to the XLA formulation."""
    v, d, f, e = 128, 64, 128, LLAMA_MOE_CFG["moe_num_experts"]
    want = {
        "tp2": (2, [("loss", (v // 2, d))]),
        "dp2_mp2": (4, [("loss", (v // 2, d))]),
        "fsdp4": (4, [("loss", (v, d))]),
        "dp2_ep2": (4, [("grouped", (e // 2, d, f)),
                        ("grouped", (e // 2, f, d)), ("loss", (v, d))]),
    }
    for name, (world, seen) in want.items():
        for res in _port_results(tmp_path_factory, world):
            assert res[f"llama_{name}_kernels"] == sorted(seen), name
    ref = reference_llama(True)
    ref_shard_llama(ref, RMesh(np.arange(4).reshape(2, 2), ["dp", "ep"]),
                    tp_axis=None, ep_axis="ep")
    assert all(layer.mlp.sharded for layer in ref.model.layers)


@pytest.mark.parametrize("mesh,single", [
    ("recipe_mesh", "recipe_single"), ("recipe_fsdp", "recipe_single"),
    ("recipe_moe_ep", "recipe_moe_single")])
def test_recipe_under_a_mesh_matches_one_device(tmp_path_factory, mesh,
                                                single):
    """``llama_pretrain.main`` with ``--mesh 2x2``, ``--mesh fsdp`` and
    ``--mesh 2x2 --moe 4 --ep`` in a world of 4 (the compiled step, each
    rank on its rows of every batch) logs the one-device recipe's losses
    within 1e-5."""
    for res in _port_results(tmp_path_factory, 4):
        assert len(res[mesh]) == 3
        np.testing.assert_allclose(res[mesh], res[single], rtol=RTOL,
                                   atol=0)


def test_generate_on_a_placed_model(tmp_path_factory):
    """Greedy ``generate`` at tp 2 (each rank's KV cache holds its kv
    heads, the logits gathered over the vocab) gives the unplaced
    model's tokens on both ranks."""
    for res in _port_results(tmp_path_factory, 2):
        plain, placed = res["llama_tp2_generate"]
        assert plain.shape == (2, 12)
        np.testing.assert_array_equal(placed, plain)


def test_shard_llama_refuses_what_does_not_split():
    cfg = tiny_llama_config(num_hidden_layers=1)
    model = LlamaForCausalLM(cfg, device="cpu")
    with pytest.raises(ValueError, match="num_key_value_heads"):
        shard_llama(model, ProcessMesh(np.arange(4), ["mp"]), tp_axis="mp")
    with pytest.raises(ValueError, match="moe_num_experts == 0"):
        shard_llama(model, ProcessMesh(np.arange(2), ["ep"]), tp_axis=None,
                    ep_axis="ep")
    with pytest.raises(ValueError, match="no axis"):
        shard_llama(model, ProcessMesh(np.arange(2), ["dp"]), tp_axis="mp")


def test_recipe_mesh_flags_refuse_what_they_cannot_run(tmp_path):
    base = ["--config", "tiny", "--device", "cpu", "--steps", "1"]
    with pytest.raises(SystemExit):
        llama_pretrain.main(base + ["--ep"])
    with pytest.raises(SystemExit):
        llama_pretrain.main(base + ["--moe", "4", "--ep"])
    with pytest.raises(NotImplementedError, match="A13 part 2"):
        llama_pretrain.main(base + ["--mesh", "1x1", "--ckpt-dir",
                                    str(tmp_path)])
    # a single process is a world of one: a 2 x 2 mesh does not fit it,
    # and the world the recipe started is gone afterwards
    with pytest.raises(ValueError, match="needs 4 ranks"):
        llama_pretrain.main(base + ["--mesh", "2x2"])
    assert not torch.distributed.is_initialized()
