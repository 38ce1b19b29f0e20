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
    h = torch.zeros(4, 32, dtype=torch.bfloat16)
    w = torch.zeros(16, 32)
    with pytest.raises(ValueError, match="f32"):
        FC._launch(h, w, torch.zeros(4, dtype=torch.long))
    with pytest.raises(ValueError, match="hidden % 8"):
        FC._launch(torch.zeros(4, 12), torch.zeros(16, 12),
                   torch.zeros(4, dtype=torch.long))
