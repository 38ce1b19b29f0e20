"""The port's fused linear cross-entropy (plain chunked forward and its
chunked backward, through the autograd Function on the CPU) against the
reference's chunked formulation ``_xla_parts`` / ``_loss_raw`` and its
Pallas kernel in interpret mode (``_kernel_parts``, vocab tiles of 16).

The same numpy hidden/weight/labels go to both; the reference's weight
is ``[D, V]``, the port's the ``nn.Linear`` ``[V, D]``. f32 lse, pick
and loss agree at atol 1e-5, gradients at atol 1e-5 (both sides sum the
same products in f32, in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.fused_linear_cross_entropy import (_kernel_parts,
                                                        _loss_raw,
                                                        _xla_parts)

from paddle_tpu_torch.ops import fused_linear_cross_entropy as FC


def _case(n=24, d=32, v=48, seed=0, ignore=(), out_of_range=()):
    rng = np.random.RandomState(seed)
    h = rng.randn(n, d).astype(np.float32)
    w = (rng.randn(v, d) * 0.2).astype(np.float32)          # [V, D]
    lab = rng.randint(0, v, (n,)).astype(np.int64)
    for i in ignore:
        lab[i] = -100
    for i in out_of_range:
        lab[i] = v + 3
    return h, w, lab


def _port_loss(h, w, lab, chunk, dtype=torch.float32):
    ht = torch.from_numpy(h).to(dtype).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    loss = FC.fused_linear_cross_entropy(ht, wt, torch.from_numpy(lab),
                                         vocab_chunk=chunk)
    loss.backward()
    return loss, ht.grad, wt.grad


def _ref_loss(h, w, lab, chunk, dtype=jnp.float32):
    f = lambda h, w: _loss_raw(h, w, jnp.asarray(lab), chunk, -100,  # noqa
                               False)
    hj = jnp.asarray(h).astype(dtype)
    loss, (dh, dw) = jax.value_and_grad(f, argnums=(0, 1))(
        hj, jnp.asarray(w.T))
    return float(loss), np.asarray(dh.astype(jnp.float32)), np.asarray(dw).T


@pytest.mark.parametrize("chunk", [8, 16, 48, 64])
@pytest.mark.parametrize("ref", ["xla", "pallas_interpret"])
def test_parts_match_reference(chunk, ref):
    h, w, lab = _case(ignore=(3, 17), out_of_range=(5,))
    lse, pick = FC.fused_linear_cross_entropy_ref(
        torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(lab),
        chunk)
    labj = jnp.asarray(lab.astype(np.int32))
    if ref == "xla":
        lse_r, pick_r = _xla_parts(jnp.asarray(h), jnp.asarray(w.T), labj,
                                   chunk)
    else:    # the Pallas kernel, vocab tiles of 16 (48 % 16 == 0)
        lse_r, pick_r = _kernel_parts(jnp.asarray(h), jnp.asarray(w.T),
                                      labj, block_v=16)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_r), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(pick.numpy(), np.asarray(pick_r), rtol=0,
                               atol=1e-5)
    # ignored and out-of-range labels match no column: pick 0
    assert pick[3] == 0 and pick[17] == 0 and pick[5] == 0


@pytest.mark.parametrize("chunk", [8, 16, 48])
def test_loss_and_grads_match_reference(chunk):
    h, w, lab = _case(ignore=(0, 5, 9))
    before = FC.launches
    loss, dh, dw = _port_loss(h, w, lab, chunk)
    loss_r, dh_r, dw_r = _ref_loss(h, w, lab, chunk)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(float(loss), loss_r, rtol=0, atol=1e-5)
    np.testing.assert_allclose(dh.numpy(), dh_r, rtol=0, atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), dw_r, rtol=0, atol=1e-5)
    assert dw.shape == (48, 32)            # [V, D], the port's layout
    assert FC.launches == before           # CPU tensors launch no kernel


def test_all_ignored_rows_give_zero():
    h, w, lab = _case()
    lab[:] = -100
    loss, dh, dw = _port_loss(h, w, lab, 16)
    assert float(loss) == 0.0 == _ref_loss(h, w, lab, 16)[0]
    assert not dh.abs().any() and not dw.abs().any()


def test_bf16_hidden():
    h, w, lab = _case(ignore=(2,))
    loss, dh, dw = _port_loss(h, w, lab, 16, dtype=torch.bfloat16)
    loss_r, dh_r, dw_r = _ref_loss(h, w, lab, 16, dtype=jnp.bfloat16)
    assert dh.dtype == torch.bfloat16 and dw.dtype == torch.float32
    np.testing.assert_allclose(float(loss), loss_r, rtol=0, atol=1e-5)
    # d_hidden is rounded to bf16 on both sides
    np.testing.assert_allclose(dh.float().numpy(), dh_r, rtol=0,
                               atol=2 ** -9 * np.abs(dh_r).max())
    np.testing.assert_allclose(dw.numpy(), dw_r, rtol=0, atol=1e-5)


def test_leading_dims_flatten_and_chunk_env(monkeypatch):
    h, w, lab = _case(n=24)
    monkeypatch.setenv("PADDLE_TPU_FUSED_CE_CHUNK", "16")
    assert FC.default_chunk() == 16
    got = FC.fused_linear_cross_entropy(
        torch.from_numpy(h).reshape(2, 12, 32), torch.from_numpy(w),
        torch.from_numpy(lab).reshape(2, 12))
    np.testing.assert_allclose(float(got), _ref_loss(h, w, lab, 16)[0],
                               rtol=0, atol=1e-5)
    monkeypatch.setenv("PADDLE_TPU_FUSED_CE_CHUNK", "junk")
    assert FC.default_chunk() == 8192
    with pytest.raises(ValueError, match="weight"):
        FC.fused_linear_cross_entropy(torch.from_numpy(h),
                                      torch.from_numpy(w.T), None)


def test_kernel_operand_checks():
    """The CUDA wrapper takes f32, bf16 and f16 hidden and weight in any
    mix and any D (``kernel_instance``'s rule picks the instance) and
    refuses only what no instance takes, before any launch (so the
    checks run on the CPU too)."""
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    assert FC.kernel_instance(bf16, f32, 32) == "tensor-core"
    assert FC.kernel_instance(f32, f32, 12) == "general"
    lab = torch.zeros(4, dtype=torch.long)
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        FC._launch(torch.zeros(4, 32, dtype=torch.int32), torch.zeros(16, 32),
                   lab)
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        FC._launch(torch.zeros(4, 32), torch.zeros(16, 32, dtype=torch.float64),
                   lab)
    odd = torch.zeros(1 + 4 * 32, dtype=f16)[1:].view(4, 32)
    with pytest.raises(ValueError, match="16-byte aligned"):
        FC._launch(odd, torch.zeros(16, 32, dtype=bf16), lab)
    assert FC.launches == 0 and not any(FC.instance_launches.values())


_F32, _BF16, _F16 = torch.float32, torch.bfloat16, torch.float16


@pytest.mark.parametrize("dtype_h,dtype_w,d,want", [
    (_F32, _F32, 4096, "tensor-core"),
    (_BF16, _BF16, 4096, "tensor-core"),
    (_F16, _F32, 136, "tensor-core"),
    (_F32, _BF16, 8, "tensor-core"),
    (_F16, _BF16, 40, "tensor-core"),
    (_F32, _F32, 4092, "general"),
    (_BF16, _F16, 37, "general"),
    (_F32, _F32, 1, "general"),
    (_F16, _F16, 12, "general")])
def test_kernel_instance_rule(dtype_h, dtype_w, d, want):
    """One rule: D % 8 == 0 takes the tensor-core instance at any mix of
    the three dtypes, every other D >= 1 the general one."""
    assert FC.kernel_instance(dtype_h, dtype_w, d) == want


@pytest.mark.parametrize("v", [1, 7, 255, 256, 257, 1000, 32000, 128256,
                               152064])
@pytest.mark.parametrize("sms", [1, 3, 132])
def test_split_plan_covers_each_column_once(v, sms):
    """The vocab split: every column in exactly one split's tiles, no
    split empty, no more splits than SMs; a function of V and the SM
    count alone (the wrapper passes nothing else, so the plan, and a
    row's lse and pick, cannot depend on N)."""
    splits, per = FC.split_plan(v, sms)
    assert 1 <= splits <= sms and per >= 1
    seen = np.zeros(v, np.int64)
    for y in range(splits):
        lo = y * per * FC.TILE_COLS
        hi = min((y + 1) * per * FC.TILE_COLS, v)
        assert lo < hi                     # every split holds columns
        seen[lo:hi] += 1
    assert (seen == 1).all()
    assert FC.split_plan(v, sms) == (splits, per)


_MIXES = [(_BF16, _BF16), (_F16, _F16), (_F32, _BF16), (_BF16, _F32),
          (_F16, _F32), (_F32, _F16), (_F16, _BF16)]
_JNP = {_F32: jnp.float32, _BF16: jnp.bfloat16, _F16: jnp.float16}


@pytest.mark.parametrize("ref", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("dtype_h,dtype_w", _MIXES)
def test_parts_at_16bit_dtypes_match_reference(dtype_h, dtype_w, ref):
    """The plain forward at bf16/f16 hidden and weight (each converted
    to f32 exactly) against the reference's chunked formulation and its
    Pallas kernel in interpret mode on the same 16-bit values: lse and
    pick at atol 1e-5, as in f32."""
    h, w, lab = _case(ignore=(3,), out_of_range=(6,))
    ht = torch.from_numpy(h).to(dtype_h)
    wt = torch.from_numpy(w).to(dtype_w)
    lse, pick = FC.fused_linear_cross_entropy_ref(ht, wt,
                                                  torch.from_numpy(lab), 16)
    hj = jnp.asarray(h).astype(_JNP[dtype_h])
    wj = jnp.asarray(w.T).astype(_JNP[dtype_w])
    labj = jnp.asarray(lab.astype(np.int32))
    if ref == "xla":
        lse_r, pick_r = _xla_parts(hj, wj, labj, 16)
    else:
        lse_r, pick_r = _kernel_parts(hj, wj, labj, block_v=16)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_r), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(pick.numpy(), np.asarray(pick_r), rtol=0,
                               atol=1e-5)
    assert pick[3] == 0 and pick[6] == 0


@pytest.mark.parametrize("dtype_h,dtype_w", _MIXES)
def test_loss_and_grads_at_16bit_dtypes_match_reference(dtype_h, dtype_w):
    """Loss and gradients through the autograd Function at bf16/f16
    hidden and weight against the reference's custom VJP: the loss at
    atol 1e-5; d_hidden in hidden's dtype and d_weight in the weight's,
    each within 2^-8 of its largest value where it is rounded to 16 bits
    (atol 1e-5 in f32)."""
    h, w, lab = _case(ignore=(1, 8))
    ht = torch.from_numpy(h).to(dtype_h).requires_grad_()
    wt = torch.from_numpy(w).to(dtype_w).requires_grad_()
    loss = FC.fused_linear_cross_entropy(ht, wt, torch.from_numpy(lab),
                                         vocab_chunk=16)
    loss.backward()
    f = lambda h, w: _loss_raw(h, w, jnp.asarray(lab), 16, -100,  # noqa
                               False)
    loss_r, (dh_r, dw_r) = jax.value_and_grad(f, argnums=(0, 1))(
        jnp.asarray(h).astype(_JNP[dtype_h]),
        jnp.asarray(w.T).astype(_JNP[dtype_w]))
    assert ht.grad.dtype == dtype_h and wt.grad.dtype == dtype_w
    np.testing.assert_allclose(float(loss.detach()), float(loss_r), rtol=0,
                               atol=1e-5)
    for got, ref, dt in ((ht.grad, dh_r, dtype_h), (wt.grad, dw_r.T,
                                                     dtype_w)):
        ref = np.asarray(ref.astype(jnp.float32))
        tol = 1e-5 if dt == _F32 else 2 ** -8 * np.abs(ref).max()
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                                   atol=tol)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int16, torch.int64])
def test_labels_of_any_integer_dtype(dtype):
    """Labels of any integer dtype give the int64 labels' lse, pick and
    loss (ignored and out-of-range rows included)."""
    h, w, lab = _case(ignore=(2,), out_of_range=(4,))
    ht, wt = torch.from_numpy(h), torch.from_numpy(w)
    want = FC.fused_linear_cross_entropy_ref(ht, wt, torch.from_numpy(lab),
                                             16)
    got = FC.fused_linear_cross_entropy_ref(
        ht, wt, torch.from_numpy(lab).to(dtype), 16)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(
        FC.fused_linear_cross_entropy(ht, wt, torch.from_numpy(lab).to(dtype),
                                      vocab_chunk=16),
        FC.fused_linear_cross_entropy(ht, wt, torch.from_numpy(lab),
                                      vocab_chunk=16))
