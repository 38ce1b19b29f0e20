"""The port's gradient clipping against the reference's ``nn.clip``:
the same seeded numpy gradients into both, value clipping bitwise, the
norm clips within rtol 1e-6 (the norms are sums in different orders);
``need_clip`` honoured, ``p.grad`` left as it was, and the norms and
scales kept as device tensors (no host read)."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.clip as jnn
from paddle_tpu.framework.tensor import Parameter

from paddle_tpu_torch.nn import clip as tnn

torch.set_num_threads(1)

SHAPES = [(4, 3), (3,), (5, 2, 2), (7,)]


def _pairs(scale=1.0, skip=()):
    rng = np.random.RandomState(0)
    ws = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    gs = [(rng.randn(*s) * scale).astype(np.float32) for s in SHAPES]
    jp = [Parameter(w.copy()) for w in ws]
    tp = [torch.nn.Parameter(torch.from_numpy(w.copy())) for w in ws]
    for i in skip:
        jp[i].need_clip = False
        tp[i].need_clip = False
    jpg = [(p, paddle.to_tensor(g)) for p, g in zip(jp, gs)]
    tpg = [(p, torch.from_numpy(g.copy())) for p, g in zip(tp, gs)]
    return jpg, tpg, gs


CLIPS = {
    "value": (lambda m: m.ClipGradByValue(0.5), 0.0),
    "value_min": (lambda m: m.ClipGradByValue(0.7, min=-0.2), 0.0),
    "norm": (lambda m: m.ClipGradByNorm(1.0), 1e-6),
    "global_norm": (lambda m: m.ClipGradByGlobalNorm(1.5), 1e-6),
    "global_norm_unclipped": (lambda m: m.ClipGradByGlobalNorm(1e3), 1e-6),
}


@pytest.mark.parametrize("skip", [(), (1, 3)])
@pytest.mark.parametrize("case", sorted(CLIPS))
def test_clip_matches_reference(case, skip):
    make, rtol = CLIPS[case]
    jpg, tpg, gs = _pairs(scale=3.0, skip=skip)
    want = make(jnn)(jpg)
    got = make(tnn)(tpg)
    for i, ((_, wg), (p, tg)) in enumerate(zip(want, got)):
        w = np.asarray(wg.numpy())
        if rtol == 0.0:
            assert np.array_equal(tg.numpy(), w), i
        else:
            np.testing.assert_allclose(tg.numpy(), w, rtol=rtol, atol=0,
                                       err_msg=str(i))
        if i in skip:
            assert np.array_equal(tg.numpy(), gs[i])
    # the gradients handed in are not changed
    for (_, g), g0 in zip(tpg, gs):
        assert np.array_equal(g.numpy(), g0)


def test_global_norm_keeps_device_tensors(monkeypatch):
    """No host read on the clip's path: neither ``item`` nor ``float`` of
    a tensor is called while it clips."""
    _, tpg, _ = _pairs(scale=3.0)

    def no_read(*a, **k):
        raise AssertionError("a host read under the clip")
    monkeypatch.setattr(torch.Tensor, "item", no_read)
    monkeypatch.setattr(torch.Tensor, "__float__", no_read)
    for make, _ in CLIPS.values():
        make(tnn)(tpg)


def test_empty_and_all_skipped():
    clip = tnn.ClipGradByGlobalNorm(1.0)
    p = torch.nn.Parameter(torch.ones(2))
    p.need_clip = False
    g = torch.full((2,), 5.0)
    assert clip([(p, g)])[0][1] is g
    assert clip([]) == []


@pytest.mark.parametrize("norm_type", [2.0, 1.0, float("inf")])
def test_clip_grad_norm_matches_reference(norm_type):
    _, _, gs = _pairs(scale=3.0)
    jp = [Parameter(np.zeros(s, np.float32)) for s in SHAPES]
    tp = [torch.nn.Parameter(torch.zeros(s)) for s in SHAPES]
    for a, b, g in zip(jp, tp, gs):
        a.grad = paddle.to_tensor(g)
        b.grad = torch.from_numpy(g.copy())
    want = jnn.clip_grad_norm_(jp, 2.0, norm_type=norm_type)
    got = tnn.clip_grad_norm_(tp, 2.0, norm_type=norm_type)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               rtol=1e-6)
    for a, b in zip(jp, tp):
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(a.grad.numpy()),
                                   rtol=1e-6, atol=0)


def test_clip_grad_value_matches_reference():
    _, _, gs = _pairs(scale=3.0)
    jp = [Parameter(np.zeros(s, np.float32)) for s in SHAPES]
    tp = [torch.nn.Parameter(torch.zeros(s)) for s in SHAPES]
    for a, b, g in zip(jp, tp, gs):
        a.grad = paddle.to_tensor(g)
        b.grad = torch.from_numpy(g.copy())
    jnn.clip_grad_value_(jp, 0.4)
    tnn.clip_grad_value_(tp, 0.4)
    for a, b in zip(jp, tp):
        assert np.array_equal(b.grad.numpy(), np.asarray(a.grad.numpy()))
    assert float(tnn.clip_grad_norm_([torch.nn.Parameter(torch.ones(1))],
                                     1.0)) == 0.0


def test_bf16_gradients_round_once():
    """A bf16 gradient is scaled in f32 and rounded back once, as in the
    reference."""
    g = torch.randn(64, generator=torch.Generator().manual_seed(0)) * 4
    p = torch.nn.Parameter(torch.zeros(64, dtype=torch.bfloat16))
    gb = g.to(torch.bfloat16)
    (_, out), = tnn.ClipGradByNorm(1.0)([(p, gb)])
    assert out.dtype == torch.bfloat16
    scale = 1.0 / torch.linalg.vector_norm(gb.float())
    assert torch.equal(out, (gb.float() * scale).to(torch.bfloat16))
