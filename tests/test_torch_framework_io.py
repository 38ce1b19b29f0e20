"""The port's ``framework.io`` ``save`` / ``load`` against the reference
package's.

Tolerances: bitwise for every buffer (a file the reference wrote, bf16
included, and the port's own round trip); exact for dtype strings,
shapes, flags and the non-tensor values.
"""

import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework import io as ref_io
from paddle_tpu.framework.tensor import Parameter

from paddle_tpu_torch.framework import io as fio

torch.set_num_threads(1)


def _arrays():
    rng = np.random.RandomState(0)
    return {"f32": rng.randn(3, 5).astype(np.float32),
            "bf16": rng.randn(4, 6).astype(np.float32),
            "i32": rng.randint(-9, 9, (7,)).astype(np.int32),
            "f16": rng.randn(2, 2).astype(np.float16)}


def _reference_state():
    a = _arrays()
    return {"w": Parameter(a["f32"], name="linear_0.w_0"),
            "bf16": paddle.to_tensor(a["bf16"]).astype("bfloat16"),
            "i32": paddle.to_tensor(a["i32"]),
            "nested": [paddle.to_tensor(a["f16"]), ("tag", 3, 2.5)],
            "LR_Scheduler": {"last_epoch": 4, "last_lr": 0.125}}


def _bits(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def test_load_reads_a_reference_file_bitwise(tmp_path):
    path = str(tmp_path / "ref.pdparams")
    state = _reference_state()
    ref_io.save(state, path)
    got = fio.load(path)
    want = ref_io.load(path)
    assert set(got) == set(want)
    assert isinstance(got["w"], torch.nn.Parameter)
    assert got["w"].requires_grad            # a trainable parameter
    assert not got["i32"].requires_grad      # stop_gradient tensors
    for key in ("w", "bf16", "i32"):
        w_arr = np.asarray(want[key]._data)
        if key == "bf16":
            assert got[key].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                _bits(got[key]), w_arr.view(np.uint16).view(np.int16))
        else:
            np.testing.assert_array_equal(_bits(got[key]), w_arr)
            assert _bits(got[key]).dtype == w_arr.dtype
    np.testing.assert_array_equal(got["nested"][0].numpy(),
                                  np.asarray(want["nested"][0]._data))
    assert got["nested"][1] == want["nested"][1] == ("tag", 3, 2.5)
    assert got["LR_Scheduler"] == want["LR_Scheduler"]


def test_payload_layout_is_the_references(tmp_path):
    """Slot for slot: the port's payload of a tensor holds what the
    reference's holds for the same values (dtype strings, shape, flags,
    the uint16 view of bf16)."""
    a = _arrays()
    ref_path, port_path = str(tmp_path / "r"), str(tmp_path / "p")
    ref_io.save({"x": paddle.to_tensor(a["bf16"]).astype("bfloat16"),
                 "y": paddle.to_tensor(a["i32"])}, ref_path)
    fio.save({"x": torch.from_numpy(a["bf16"]).to(torch.bfloat16),
              "y": torch.from_numpy(a["i32"])}, port_path)
    with open(ref_path, "rb") as f:
        ref_raw = fio._Unpickler(f).load()
    with open(port_path, "rb") as f:
        port_raw = pickle.load(f)
    for k in ("x", "y"):
        r, p = ref_raw[k], port_raw[k]
        assert type(r) is type(p) is fio._TensorPayload
        for slot in ("dtype", "shape", "stop_gradient", "is_param"):
            assert getattr(r, slot) == getattr(p, slot), (k, slot)
        assert r.buffer.dtype == p.buffer.dtype
        np.testing.assert_array_equal(r.buffer, p.buffer)


def test_round_trip_is_bitwise(tmp_path):
    gen = torch.Generator().manual_seed(1)
    lin = torch.nn.Linear(4, 3)
    state = {"model": lin.state_dict(keep_vars=True),
             "bf16": torch.randn(5, 7, generator=gen).to(torch.bfloat16),
             "i64": torch.arange(6).reshape(2, 3),
             "list": [torch.randn(2, generator=gen), "s", None],
             "step": 12}
    path = str(tmp_path / "sub" / "x.pdparams")
    fio.save(state, path)
    got = fio.load(path)
    for k, t in state["model"].items():
        assert isinstance(got["model"][k], torch.nn.Parameter)
        assert torch.equal(got["model"][k], t.detach())
    assert torch.equal(got["bf16"].view(torch.int16),
                       state["bf16"].view(torch.int16))
    assert got["i64"].dtype == torch.int64
    assert torch.equal(got["i64"], state["i64"])
    assert torch.equal(got["list"][0], state["list"][0])
    assert got["list"][1:] == ["s", None] and got["step"] == 12
    # a module saves as its state dict, parameters kept as parameters
    fio.save(lin, path)
    assert all(isinstance(v, torch.nn.Parameter)
               for v in fio.load(path).values())


def test_return_numpy_widens_bf16_only(tmp_path):
    """``return_numpy=True``: every buffer as the reference returns it,
    but bf16, which numpy cannot hold: its values widened to f32, exactly
    (a stated difference; the reference returns an ml_dtypes array)."""
    path = str(tmp_path / "ref.pdparams")
    ref_io.save(_reference_state(), path)
    got = fio.load(path, return_numpy=True)
    want = ref_io.load(path, return_numpy=True)
    for key in ("w", "i32"):
        assert got[key].dtype == np.asarray(want[key]).dtype
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    assert got["bf16"].dtype == np.float32
    np.testing.assert_array_equal(
        got["bf16"], np.asarray(want["bf16"]).astype(np.float32))


def test_reference_load_of_a_port_file_returns_payloads(tmp_path):
    """Stated difference: a file the port writes names the port's payload
    class, so the reference's ``load`` returns those payloads unconverted
    (it knows only its own class); the port's ``load`` reads it."""
    path = str(tmp_path / "port.pdparams")
    fio.save({"x": torch.ones(2)}, path)
    got = ref_io.load(path)
    assert isinstance(got["x"], fio._TensorPayload)
    assert torch.equal(fio.load(path)["x"], torch.ones(2))


@pytest.mark.parametrize("proto", [2, 4])
def test_protocols(tmp_path, proto):
    path = str(tmp_path / "p")
    fio.save({"x": torch.arange(3.0)}, path, protocol=proto)
    assert torch.equal(fio.load(path)["x"], torch.arange(3.0))
