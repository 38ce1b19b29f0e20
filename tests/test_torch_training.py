"""The port's training path against the reference on a tiny Llama (2
layers, batch 2, seq 128, so both sides take their flash attention path
and the fused linear cross-entropy), with the weights carried across by
``load_numpy_state``; plus recompute, the materialized-loss switch, the
prefetcher and the recipe's entry point.

Tolerances: f32 loss and every gradient within 1e-4 relative to the
gradient tensor's largest value (the frameworks sum in different
orders); 5-step AdamW loss curves within 1e-4 in f32 and 2e-2 under bf16
``auto_cast`` (bf16 rounding of the activations differs in place).
"""

import os
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import tiny_llama_config as jax_tiny

from paddle_tpu_torch import amp
from paddle_tpu_torch.examples import llama_pretrain
from paddle_tpu_torch.io import DevicePrefetcher
from paddle_tpu_torch.models import (LlamaForCausalLM, load_numpy_state,
                                     tiny_llama_config)
from paddle_tpu_torch.ops import flash_attention as FT
from paddle_tpu_torch.ops import fused_linear_cross_entropy as FC

# One intra-op thread a process: the suite runs in parallel worker
# processes (xdist), and OpenMP threads that spin for a core each
# slow every small CPU op of the port many times over.
torch.set_num_threads(1)

B, S = 2, 128


def _pair(seed=0, **cfg):
    paddle.seed(seed)
    jm = JaxLlama(jax_tiny(num_hidden_layers=2, **cfg))
    arrays = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(tiny_llama_config(num_hidden_layers=2, **cfg),
                          device="cpu")
    return jm, load_numpy_state(tm, arrays)


def _batch(seed, vocab=128):
    ids = np.random.RandomState(seed).randint(0, vocab, (B, S + 1))
    return ids[:, :-1].astype(np.int64), ids[:, 1:].astype(np.int64)


def _linear_names(tm):
    return {n + ".weight" for n, m in tm.named_modules()
            if isinstance(m, torch.nn.Linear)}


def test_loss_and_grads_match_reference():
    jm, tm = _pair()
    x, y = _batch(1)
    loss_j, logits_j = jm(paddle.to_tensor(x), paddle.to_tensor(y))
    loss_j.backward()
    loss_t, logits_t = tm(torch.from_numpy(x), torch.from_numpy(y))
    loss_t.backward()
    assert logits_j is None and logits_t is None      # fused loss path
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-4)
    linear = _linear_names(tm)
    tparams = dict(tm.named_parameters())
    names = [n for n, _ in jm.named_parameters()]
    assert sorted(names) == sorted(tparams)
    for name, p in jm.named_parameters():
        want = np.asarray(p.grad.numpy())
        got = tparams[name].grad.numpy()
        if name in linear:
            got = got.T
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)
    assert tm.flops_per_token(S) == jm.flops_per_token(S)


def _curve_jax(jm, batches, use_amp):
    opt = paddle.optimizer.AdamW(learning_rate=1e-3, weight_decay=0.1,
                                 parameters=jm.parameters())
    out = []
    for x, y in batches:
        with paddle.amp.auto_cast(enable=use_amp, dtype="bfloat16"):
            loss, _ = jm(paddle.to_tensor(x), paddle.to_tensor(y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        out.append(float(loss))
    return out


def _curve_port(tm, batches, use_amp):
    from paddle_tpu_torch.optimizer import AdamW
    opt = AdamW(learning_rate=1e-3, weight_decay=0.1,
                parameters=tm.named_parameters())
    out = []
    for x, y in batches:
        with amp.auto_cast(enable=use_amp, dtype="bfloat16"):
            loss, _ = tm(torch.from_numpy(x), torch.from_numpy(y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        out.append(loss.item())
    return out


@pytest.fixture
def dtype_spy():
    """Records the input dtypes the flash and loss plain versions get."""
    seen = {"flash": set(), "ce": set()}
    fwd, ce = FT.flash_attention_fwd_ref, FC.fused_linear_cross_entropy_ref

    def flash_spy(q, k, v, *a, **kw):
        seen["flash"].add((q.dtype, k.dtype, v.dtype))
        return fwd(q, k, v, *a, **kw)

    def ce_spy(h, w, *a, **kw):
        seen["ce"].add((h.dtype, w.dtype))
        return ce(h, w, *a, **kw)
    FT.flash_attention_fwd_ref = flash_spy
    FC.fused_linear_cross_entropy_ref = ce_spy
    yield seen
    FT.flash_attention_fwd_ref = fwd
    FC.fused_linear_cross_entropy_ref = ce


@pytest.mark.parametrize("use_amp,tol", [(False, 1e-4), (True, 2e-2)])
def test_adamw_loss_curve_matches_reference(use_amp, tol, dtype_spy):
    jm, tm = _pair(seed=3)
    batches = [_batch(10 + i) for i in range(5)]
    want = _curve_jax(jm, batches, use_amp)
    got = _curve_port(tm, batches, use_amp)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    assert got[-1] < got[0]
    # the reference's per-op dtypes: flash in bf16 under auto_cast, the
    # loss on the f32 final-norm output and the f32 lm head
    act = torch.bfloat16 if use_amp else torch.float32
    assert dtype_spy["flash"] == {(act,) * 3}
    assert dtype_spy["ce"] == {(torch.float32, torch.float32)}


def test_recompute_matches_plain_forward():
    _, tm = _pair(seed=4)
    _, tr = _pair(seed=4)
    tr.config.recompute = True
    x, y = (torch.from_numpy(a) for a in _batch(2))
    for m in (tm, tr):
        with amp.auto_cast(dtype="bfloat16"):
            loss, _ = m(x, y)
        loss.backward()
        m.loss = loss.item()
    assert tm.loss == tr.loss
    for (n, p), (_, q) in zip(tm.named_parameters(), tr.named_parameters()):
        assert torch.equal(p.grad, q.grad), n
    # "dots": the products' outputs kept, the rest recomputed; gradients
    # within 1e-6 relative of no recompute
    tr.config.recompute = "dots"
    tr.zero_grad(set_to_none=True)
    with amp.auto_cast(dtype="bfloat16"):
        loss, _ = tr(x, y)
    loss.backward()
    assert loss.item() == tm.loss
    for (n, p), (_, q) in zip(tm.named_parameters(), tr.named_parameters()):
        np.testing.assert_allclose(q.grad.float().numpy(),
                                   p.grad.float().numpy(), rtol=1e-6,
                                   atol=1e-6 * p.grad.abs().max().item(),
                                   err_msg=n)


def test_recompute_dots_matches_reference():
    """``recompute="dots"`` on both sides (the reference's
    ``dots_with_no_batch_dims_saveable``, the port's selective
    checkpoint): loss and every gradient at the f32 tolerance above, and
    the port's outputs of the 2-D products saved, the rest recomputed."""
    import importlib
    R = importlib.import_module("paddle_tpu_torch.distributed.recompute")
    jm, tm = _pair(seed=6, recompute="dots")
    x, y = _batch(4)
    loss_j, _ = jm(paddle.to_tensor(x), paddle.to_tensor(y))
    loss_j.backward()
    seen = []
    orig = R._dots_policy

    def spy(ctx, op, *a, **kw):
        policy = orig(ctx, op, *a, **kw)
        if not ctx.is_recompute:
            seen.append((str(op), policy.name))
        return policy
    R._dots_policy = spy
    try:
        loss_t, _ = tm(torch.from_numpy(x), torch.from_numpy(y))
        loss_t.backward()
    finally:
        R._dots_policy = orig
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-4)
    linear = _linear_names(tm)
    tparams = dict(tm.named_parameters())
    for name, p in jm.named_parameters():
        want = np.asarray(p.grad.numpy())
        got = tparams[name].grad.numpy()
        if name in linear:
            got = got.T
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)
    saved = {op for op, pol in seen if pol == "MUST_SAVE"}
    assert saved == {"aten.mm.default"}
    assert sum(1 for op, pol in seen if pol == "MUST_SAVE") == 7 * 2
    assert ("aten.bmm.default", "PREFER_RECOMPUTE") in seen


@pytest.mark.parametrize("cfg", [{}, {"tie_word_embeddings": True}])
def test_materialized_loss_matches_reference(cfg, monkeypatch):
    jm, tm = _pair(seed=5, **cfg)
    x, y = _batch(3)
    y[0, :7] = -100
    fused = tm(torch.from_numpy(x), torch.from_numpy(y))[0].item()
    monkeypatch.setenv("PADDLE_TPU_FUSED_CE", "0")
    loss_j, logits_j = jm(paddle.to_tensor(x), paddle.to_tensor(y))
    loss_t, logits_t = tm(torch.from_numpy(x), torch.from_numpy(y))
    assert logits_t.shape == (B, S, 128) and logits_j is not None
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(logits_t.detach().numpy(),
                               np.asarray(logits_j.numpy()), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(loss_t.item(), fused, rtol=1e-5)


def test_cross_entropy_matches_reference():
    import paddle_tpu.nn.functional as PF
    from paddle_tpu_torch.nn import functional as F
    rng = np.random.RandomState(6)
    logits = rng.randn(12, 7).astype(np.float32)
    lab = rng.randint(0, 7, (12,))
    lab[[1, 4]] = -100
    w = rng.rand(7).astype(np.float32)
    for kw in ({}, {"weight": w}, {"label_smoothing": 0.1},
               {"reduction": "sum"}, {"reduction": "none"}):
        jw = {k: paddle.to_tensor(v) if isinstance(v, np.ndarray) else v
              for k, v in kw.items()}
        tw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
              for k, v in kw.items()}
        want = PF.cross_entropy(paddle.to_tensor(logits),
                                paddle.to_tensor(lab), **jw).numpy()
        got = F.cross_entropy(torch.from_numpy(logits), torch.from_numpy(lab),
                              **tw)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6, err_msg=str(kw))
    soft = rng.rand(12, 7).astype(np.float32)
    want = PF.cross_entropy(paddle.to_tensor(logits), paddle.to_tensor(soft),
                            soft_label=True).numpy()
    got = F.cross_entropy(torch.from_numpy(logits), torch.from_numpy(soft),
                          soft_label=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    # black-listed under auto_cast: bf16 logits are lifted to f32
    with amp.auto_cast(dtype="bfloat16"):
        got = F.cross_entropy(torch.from_numpy(logits).bfloat16(),
                              torch.from_numpy(lab))
    assert got.dtype == torch.float32


def test_auto_cast_policy():
    assert amp.op_dtype("linear") is None
    with amp.auto_cast(dtype="bfloat16", custom_black_list={"matmul"}):
        assert amp.op_dtype("flash_attention") == torch.bfloat16
        assert amp.op_dtype("cross_entropy") == torch.float32
        assert amp.op_dtype("matmul") == torch.float32
        assert amp.op_dtype("fused_linear_cross_entropy") is None
        # matmul left the white list: torch's autocast stays off
        assert torch.matmul(torch.ones(2, 2), torch.ones(2, 2)).dtype \
            == torch.float32
        with amp.auto_cast(enable=False):
            assert amp.op_dtype("flash_attention") is None
    with amp.auto_cast(dtype="float16"):
        assert torch.nn.functional.linear(torch.ones(2, 2), torch.ones(
            2, 2)).dtype == torch.float16
    assert amp.op_dtype("flash_attention") is None
    with pytest.raises(ValueError):
        amp.auto_cast(level="O3")


def test_prefetcher_order_transform_and_end():
    src = (np.full((2, 3), i, np.int64) for i in range(4))
    with DevicePrefetcher(src, transform=lambda a: (a, a + 1),
                          device="cpu") as feed:
        got = [(int(x[0, 0]), int(y[0, 0])) for x, y in feed]
        assert got == [(0, 1), (1, 2), (2, 3), (3, 4)]
        assert feed.batches == 4
        with pytest.raises(StopIteration):      # sticky end
            next(feed)
        stall, wall = feed.mark()
        assert 0 <= stall <= wall


def test_prefetcher_source_error_reraises():
    def src():
        yield np.zeros(2)
        raise KeyError("broken source")
    feed = DevicePrefetcher(src(), device="cpu")
    assert isinstance(next(feed), torch.Tensor)
    for _ in range(2):                          # sticky error
        with pytest.raises(KeyError, match="broken source"):
            next(feed)
    feed.close()


def test_prefetcher_close_stops_worker():
    def endless():
        while True:
            yield np.zeros(4)
    feed = DevicePrefetcher(endless(), depth=2, device="cpu")
    next(feed)
    workers = [t for t in threading.enumerate()
               if t.name == "device-prefetch"]
    feed.close()
    for t in workers:
        t.join(timeout=5)
    assert not feed._thread.is_alive()
    with pytest.raises(StopIteration):
        next(feed)


def test_recipe_main_on_cpu(tmp_path):
    res = llama_pretrain.main(["--config", "tiny", "--steps", "2",
                               "--device", "cpu"])
    assert len(res["losses"]) == 2 and all(np.isfinite(res["losses"]))
    # --ckpt-dir is ported: the recipe writes the reference's format
    res = llama_pretrain.main(["--config", "tiny", "--steps", "1",
                               "--device", "cpu", "--ckpt-dir",
                               str(tmp_path)])
    assert sorted(os.listdir(tmp_path)) == ["metadata_p0.json",
                                            "shards_p0.npz"]
    # --mesh and --ep are ported: a 2x4 mesh needs 8 ranks (a single
    # process is a world of one), --ep needs --moe and a mesh
    with pytest.raises(ValueError, match="needs 8 ranks"):
        llama_pretrain.main(["--device", "cpu", "--mesh", "2x4"])
    for flag in (["--ep"], ["--moe", "4", "--ep"]):
        with pytest.raises(SystemExit):
            llama_pretrain.main(["--device", "cpu", *flag])


def test_recipe_moe_matches_reference_recipe(monkeypatch):
    """``--moe 4`` through ``main``: the reference recipe's three steps
    (its model drawn after ``paddle.seed(0)``, carried across; AdamW lr
    3e-4, weight decay 0.1; the step compiled after an eager warm-up on
    ``[1, 17]`` ids of ``RandomState(0)``; synthetic batches of
    ``RandomState(1)``) give the same losses within 1e-5 relative, the
    dense recipe's tolerance."""
    steps, batch, seq = 3, 4, 16
    cfg = dict(num_hidden_layers=2, moe_num_experts=4, moe_top_k=2)
    paddle.seed(0)
    jm = JaxLlama(jax_tiny(**cfg))
    arrays = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    jopt = paddle.optimizer.AdamW(learning_rate=3e-4, weight_decay=0.1,
                                  parameters=jm.parameters())

    def jstep(ids, labels):
        loss, _ = jm(ids, labels)
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        return loss
    compiled = paddle.jit.to_static(jstep, state=[jm, jopt], warmup="once")

    def split(ids):
        ids = ids.astype(np.int64)
        return paddle.to_tensor(ids[:, :-1]), paddle.to_tensor(ids[:, 1:])
    compiled(*split(np.random.RandomState(0).randint(0, 128, (1, seq + 1))))
    feed = llama_pretrain.synthetic_batches(128, batch, seq, seed=1)
    want = [float(compiled(*split(next(feed)))) for _ in range(steps)]

    built = {}

    def build(config, layers=None, device=None, seed=0, recompute=False,
              moe=0, moe_top_k=2):
        tm = LlamaForCausalLM(tiny_llama_config(
            num_hidden_layers=2, moe_num_experts=moe, moe_top_k=moe_top_k),
            device=device)
        built["model"] = tm
        return load_numpy_state(tm, arrays)
    monkeypatch.setattr(llama_pretrain, "build_model", build)
    res = llama_pretrain.main(["--config", "tiny", "--device", "cpu",
                               "--moe", "4", "--steps", str(steps),
                               "--batch", str(batch)])
    mlp = built["model"].model.layers[0].mlp
    assert type(mlp).__name__ == "LlamaMoEMLP" and mlp.num_experts == 4
    np.testing.assert_allclose(res["losses"], want, rtol=1e-5, atol=0)


def _corpus(path, vocab=128, samples=12, seq=16, seed=4):
    np.random.RandomState(seed).randint(
        0, vocab, (samples, seq + 1)).astype(np.int32).tofile(path)
    return str(path)


def test_recipe_curve_matches_reference(tmp_path):
    """The recipe's compiled path against the reference recipe's steps:
    the same weights (``load_numpy_state``), the same native
    ``TokenFeed`` batches, AdamW with a global-norm clip and a
    warm-up-then-cosine schedule, the same eager warm-up on a tiny batch
    first; the 5 losses within 1e-5 relative."""
    from paddle_tpu import native as jnative
    from paddle_tpu_torch import native as tnative
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW, lr as tlr
    path = _corpus(tmp_path / "corpus.bin")
    steps, batch, seq = 5, 2, 16
    jm, tm = _pair(seed=5)
    jsched = paddle.optimizer.lr.LinearWarmup(
        paddle.optimizer.lr.CosineAnnealingDecay(1e-3, T_max=steps), 2,
        1e-4, 1e-3)
    jopt = paddle.optimizer.AdamW(
        learning_rate=jsched, weight_decay=0.1, parameters=jm.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))

    def jstep(ids, labels):
        loss, _ = jm(ids, labels)
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        return loss
    compiled = paddle.jit.to_static(jstep, state=[jm, jopt], warmup="once")

    def split(ids):
        ids = ids.astype(np.int64)
        return paddle.to_tensor(ids[:, :-1]), paddle.to_tensor(ids[:, 1:])
    wids = np.random.RandomState(0).randint(0, 128, (1, seq + 1))
    compiled(*split(wids))
    feed = jnative.TokenFeed(path, seq + 1, batch, seed=0)
    want = []
    for _ in range(steps):
        want.append(float(compiled(*split(next(feed)))))
        jsched.step()
    feed.close()

    tsched = tlr.LinearWarmup(tlr.CosineAnnealingDecay(1e-3, T_max=steps),
                              2, 1e-4, 1e-3)
    topt = AdamW(learning_rate=tsched, weight_decay=0.1,
                 parameters=tm.named_parameters(),
                 grad_clip=ClipGradByGlobalNorm(1.0))
    res = llama_pretrain.train(
        tm, steps, batch, seq, source=tnative.TokenFeed(path, seq + 1, batch,
                                                        seed=0),
        log=lambda s: None, compiled=True, opt=topt)
    assert res["feed"] == "paddle_tpu_torch.native.TokenFeed"
    np.testing.assert_allclose(res["losses"], want, rtol=1e-5, atol=0)
    assert tsched.last_epoch == jsched.last_epoch


def test_recipe_ckpt_then_resume_on_cpu(tmp_path):
    """``--data`` and ``--ckpt-dir``, then ``--resume``: the resumed model
    and optimizer state equal the saved one bitwise, and a resumed run
    that goes on trains from it."""
    path = _corpus(tmp_path / "corpus.bin")
    ck = str(tmp_path / "ckpt")
    base = ["--config", "tiny", "--device", "cpu", "--batch", "2",
            "--data", path, "--ckpt-dir", ck]
    res = llama_pretrain.main(base + ["--steps", "3"])
    saved = llama_pretrain.train_state(res["model"], res["opt"])
    saved = {k: {n: t.clone() for n, t in d.items()}
             for k, d in saved.items()}
    assert "load_s" not in res and res["ckpt_bytes"] > 0
    back = llama_pretrain.main(base + ["--steps", "0", "--resume"])
    assert back["load_s"] >= 0 and "write_s" not in back
    got = llama_pretrain.train_state(back["model"], back["opt"])
    assert sorted(got["opt"]) == sorted(saved["opt"])
    for part in ("model", "opt"):
        for n, t in saved[part].items():
            assert torch.equal(got[part][n], t), n
    more = llama_pretrain.main(base + ["--steps", "2", "--resume"])
    assert len(more["losses"]) == 2 and all(np.isfinite(more["losses"]))
