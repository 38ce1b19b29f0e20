"""The port's checkpoints against the reference's: one on-disk format, so
a save of either package loads into the other bitwise (f32, bf16 and
integer tensors, nested dicts, object values), and a step committed by
either package's ``CheckpointManager`` passes the other's
``verify_step``. Then the reference's manager cases on the port: torn
``.tmp`` directories, the bitflip fallback, retention, async errors, the
same-step re-save, the metrics kill switch, and a worker process
SIGKILLed at ``ckpt.write``, ``ckpt.before_marker`` and ``rename`` or
sent SIGTERM for its emergency save."""

import json
import os
import signal
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import checkpoint as jckpt
from paddle_tpu.distributed.checkpoint_manager import \
    CheckpointManager as JManager

from paddle_tpu_torch.distributed import checkpoint as tckpt
from paddle_tpu_torch.distributed.checkpoint_manager import (
    CheckpointCorruptError, CheckpointManager)
from paddle_tpu_torch.testing import faults

torch.set_num_threads(1)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture(autouse=True)
def _fresh_fault_plan(monkeypatch):
    monkeypatch.delenv(faults.PLAN_ENV, raising=False)
    faults.reset()
    yield
    faults.reset()


def _arrays():
    rng = np.random.RandomState(0)
    return {"w": rng.randn(5, 3).astype(np.float32),
            "h": rng.randn(4, 8).astype(np.float32),   # stored as bf16
            "ids": rng.randint(-9, 9, (6,)).astype(np.int32),
            "step": np.asarray(7, np.int32)}


def _torch_state(arrays, scale=1.0):
    return {"model": {"w": torch.from_numpy(arrays["w"] * scale),
                      "h": torch.from_numpy(arrays["h"] * scale).to(
                          torch.bfloat16)},
            "ids": torch.from_numpy(arrays["ids"].copy()),
            "step": torch.from_numpy(arrays["step"].copy()),
            "sched": {"last_epoch": 3, "base_lr": 0.5}}


def _jax_state(arrays, scale=1.0):
    return {"model": {"w": paddle.to_tensor(arrays["w"] * scale),
                      "h": paddle.to_tensor(jnp.asarray(
                          arrays["h"] * scale, jnp.bfloat16))},
            "ids": paddle.to_tensor(arrays["ids"].copy()),
            "step": paddle.to_tensor(arrays["step"].copy()),
            "sched": {"last_epoch": 3, "base_lr": 0.5}}


def _torch_bits(state):
    return {"w": state["model"]["w"].numpy().tobytes(),
            "h": state["model"]["h"].view(torch.int16).numpy().tobytes(),
            "ids": state["ids"].numpy().tobytes(),
            "step": state["step"].numpy().tobytes()}


def _jax_bits(state):
    return {"w": np.asarray(state["model"]["w"]._data).tobytes(),
            "h": np.asarray(state["model"]["h"]._data).view(
                np.int16).tobytes(),
            "ids": np.asarray(state["ids"]._data).tobytes(),
            "step": np.asarray(state["step"]._data).tobytes()}


def test_port_save_loads_in_reference(tmp_path):
    arrays = _arrays()
    src = _torch_state(arrays)
    tckpt.save_state_dict(src, str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["metadata_p0.json",
                                            "shards_p0.npz"]
    dst = _jax_state(arrays, scale=0.0)
    dst["sched"] = {"last_epoch": 0, "base_lr": 0.0}
    jckpt.load_state_dict(dst, str(tmp_path))
    assert _jax_bits(dst) == _torch_bits(src)
    assert dst["sched"] == {"last_epoch": 3, "base_lr": 0.5}


def test_reference_save_loads_in_port(tmp_path):
    arrays = _arrays()
    src = _jax_state(arrays)
    jckpt.save_state_dict(src, str(tmp_path))
    dst = _torch_state(arrays, scale=0.0)
    dst["sched"] = {"last_epoch": 0, "base_lr": 0.0}
    storage = dst["model"]["w"].data_ptr()
    tckpt.load_state_dict(dst, str(tmp_path))
    assert _torch_bits(dst) == _jax_bits(src)
    assert dst["model"]["w"].data_ptr() == storage      # filled in place
    assert dst["sched"] == {"last_epoch": 3, "base_lr": 0.5}


def test_metadata_matches_reference(tmp_path):
    arrays = _arrays()
    tckpt.save_state_dict(_torch_state(arrays), str(tmp_path / "t"))
    jckpt.save_state_dict(_jax_state(arrays), str(tmp_path / "j"))
    mt = json.load(open(tmp_path / "t" / "metadata_p0.json"))
    mj = json.load(open(tmp_path / "j" / "metadata_p0.json"))
    assert mt == mj


def test_load_errors(tmp_path):
    tckpt.save_state_dict({"w": torch.zeros(2, 3)}, str(tmp_path))
    with pytest.raises(ValueError, match="shape"):
        tckpt.load_state_dict({"w": torch.zeros(3, 2)}, str(tmp_path))
    with pytest.raises(KeyError, match="missing"):
        tckpt.load_state_dict({"v": torch.zeros(2)}, str(tmp_path))
    with pytest.raises(FileNotFoundError):
        tckpt.load_state_dict({"w": torch.zeros(2, 3)},
                              str(tmp_path / "none"))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_committed_step_verifies_in_other_package(tmp_path, writer):
    arrays = _arrays()
    if writer == "port":
        CheckpointManager(str(tmp_path), async_save=False).save(
            _torch_state(arrays), 4)
        reader = JManager(str(tmp_path), async_save=False)
        dst = _jax_state(arrays, scale=0.0)
    else:
        JManager(str(tmp_path), async_save=False).save(
            _jax_state(arrays), 4)
        reader = CheckpointManager(str(tmp_path), async_save=False)
        dst = _torch_state(arrays, scale=0.0)
    reader.verify_step(4)
    assert reader.restore_latest(dst) == 4
    bits = _jax_bits if writer == "port" else _torch_bits
    assert bits(dst)["w"] == arrays["w"].tobytes()


# -- the reference's manager cases, on the port ------------------------------
def _state(val, dtype=torch.float32):
    return {"w": torch.full((4, 3), val, dtype=dtype),
            "b": torch.arange(3, dtype=dtype) + val}


def _same(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


class TestAtomicCommit:
    def test_commit_layout_and_roundtrip(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        mgr.save(_state(1.5), 0)
        assert mgr.latest_step() == 0
        d = mgr.step_dir(0)
        marker = json.load(open(os.path.join(d, "COMMITTED")))
        assert marker["step"] == 0
        assert set(marker["files"]) == {"shards_p0.npz",
                                        "metadata_p0.json"}
        for name, rec in marker["files"].items():
            assert os.path.getsize(os.path.join(d, name)) == rec["size"]
        dst = _state(0.0)
        assert mgr.restore_latest(dst) == 0
        assert _same(dst, _state(1.5))
        assert not os.path.exists(d + ".tmp")

    def test_torn_tmp_is_invisible_and_swept(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        torn = mgr.step_dir(5) + ".tmp"
        os.makedirs(torn)
        with open(os.path.join(torn, "shards_p0.npz"), "wb") as f:
            f.write(b"partial garbage")
        assert mgr.latest_step() is None
        assert mgr.restore_latest(_state(0.0)) is None
        mgr.save(_state(2.0), 0)
        assert not os.path.exists(torn)
        assert mgr.committed_steps() == [0]

    def test_checksum_rejects_bitflip_and_falls_back(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        mgr.save(_state(1.0), 0)
        mgr.save(_state(2.0), 1)
        faults.bitflip(os.path.join(mgr.step_dir(1), "shards_p0.npz"))
        with pytest.raises(CheckpointCorruptError, match="checksum"):
            mgr.verify_step(1)
        dst = _state(0.0)
        assert mgr.restore_latest(dst) == 0
        assert _same(dst, _state(1.0))

    def test_all_steps_corrupt_raises(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        mgr.save(_state(1.0), 0)
        faults.bitflip(os.path.join(mgr.step_dir(0), "metadata_p0.json"))
        with pytest.raises(RuntimeError, match="no restorable"):
            mgr.restore_latest(_state(0.0))

    def test_missing_committed_file_detected(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        mgr.save(_state(1.0), 0)
        os.remove(os.path.join(mgr.step_dir(0), "shards_p0.npz"))
        with pytest.raises(CheckpointCorruptError, match="missing"):
            mgr.verify_step(0)

    def test_resave_same_step_overwrites(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        mgr.save(_state(1.0), 0)
        mgr.save(_state(9.0), 0)
        dst = _state(0.0)
        assert mgr.restore_latest(dst) == 0
        assert _same(dst, _state(9.0))
        assert not os.path.exists(mgr.step_dir(0) + ".old")

    @pytest.mark.parametrize("point", ["ckpt.write", "rename"])
    def test_resave_crash_keeps_previous_commit(self, tmp_path,
                                                monkeypatch, point):
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        mgr.save(_state(1.0), 0)
        monkeypatch.setenv(faults.PLAN_ENV, json.dumps(
            [{"point": point, "action": "raise", "count": 1}]))
        faults.reset()
        with pytest.raises(OSError):
            mgr.save(_state(9.0), 0)
        dst = _state(0.0)
        assert mgr.restore_latest(dst) == 0
        assert _same(dst, _state(1.0))
        assert CheckpointManager(str(tmp_path)).latest_step() == 0


class TestRetentionAndAsync:
    @pytest.mark.parametrize("keep,want", [(2, [3, 4]), (1, [4]),
                                           (None, [0, 1, 2, 3, 4])])
    def test_gc(self, tmp_path, keep, want):
        mgr = CheckpointManager(str(tmp_path), max_to_keep=keep,
                                async_save=False)
        for s in range(5):
            mgr.save(_state(float(s)), s)
        assert mgr.committed_steps() == want
        assert mgr.latest_step() == 4

    def test_max_to_keep_zero_rejected(self, tmp_path):
        with pytest.raises(ValueError, match="max_to_keep"):
            CheckpointManager(str(tmp_path), max_to_keep=0)

    def test_snapshot_isolates_training_mutation(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), async_save=True)
        st = _state(3.0)
        mgr.save(st, 0)
        st["w"].add_(100.0)                  # the next train step
        st["b"].mul_(0.0)
        mgr.wait()
        dst = _state(0.0)
        assert mgr.restore_latest(dst) == 0
        assert _same(dst, _state(3.0))

    def test_async_failure_surfaces(self, tmp_path, monkeypatch):
        monkeypatch.setenv(faults.PLAN_ENV, json.dumps(
            [{"point": "rename", "action": "raise", "count": 1}]))
        faults.reset()
        mgr = CheckpointManager(str(tmp_path), async_save=True)
        mgr.save(_state(1.0), 0)
        with pytest.raises(OSError, match="fault injected"):
            mgr.wait()
        assert mgr.latest_step() is None
        mgr.save(_state(1.0), 0)
        mgr.save(_state(2.0), 1)             # joins the first, no error
        mgr.wait()
        assert mgr.latest_step() == 1

    def test_disabled_metrics_are_null(self, tmp_path, monkeypatch):
        from paddle_tpu_torch.observability import metrics as om
        monkeypatch.setenv("PADDLE_TPU_METRICS", "0")
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        assert mgr._m_saves is om.NULL and mgr._m_last is om.NULL
        mgr.save(_state(1.0), 0)
        assert mgr.restore_latest(_state(0.0)) == 0
        assert os.listdir(str(tmp_path)) == [
            os.path.basename(mgr.step_dir(0))]

    def test_enabled_metrics_count(self, tmp_path):
        from paddle_tpu_torch.observability import metrics as om
        mgr = CheckpointManager(str(tmp_path), async_save=False)
        saves0, restores0 = mgr._m_saves.value, mgr._m_restores.value
        mgr.save(_state(1.0), 0)
        mgr.restore_latest(_state(0.0))
        assert mgr._m_saves.value == saves0 + 1
        assert mgr._m_restores.value == restores0 + 1
        assert om.default_registry().get(
            "checkpoint_last_committed_step").value == 0


# a worker that really dies: the update is f64 math, so the parent
# recomputes the expected weights bitwise
WORKER = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, %r)
    import torch
    from paddle_tpu_torch.distributed.checkpoint_manager import \\
        CheckpointManager
    from paddle_tpu_torch.testing import faults

    root, steps, freq = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    mgr = CheckpointManager(root, max_to_keep=None, async_save=False)
    state = {"w": torch.zeros(4, dtype=torch.float64)}
    s = mgr.restore_latest(state)
    start = 0 if s is None else s + 1
    print("resume_from", start, flush=True)
    w = state["w"].clone()
    holder = {"w": w, "next": start}
    mgr.install_preemption_handler(
        lambda: {"w": holder["w"]},
        step_fn=lambda: holder["next"] - 1 if holder["next"] > 0 else None)
    for step in range(start, steps):
        faults.fire("train.step", step=step)
        w = w * 1.5 + step
        holder["w"] = w
        holder["next"] = step + 1
        if (step + 1) %% freq == 0:
            mgr.save({"w": w}, step)
    print("final", " ".join(repr(float(x)) for x in w), flush=True)
""") % REPO


def _weights_through(last_step):
    w = np.zeros((4,), np.float64)
    for step in range(last_step + 1):
        w = w * 1.5 + step
    return w


def _run_worker(tmp_path, root, steps=6, freq=1, plan=None):
    script = tmp_path / "ckpt_worker.py"
    script.write_text(WORKER)
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", faults.PLAN_ENV)}
    if plan is not None:
        env[faults.PLAN_ENV] = json.dumps(plan)
    return subprocess.run(
        [sys.executable, str(script), str(root), str(steps), str(freq)],
        env=env, capture_output=True, text=True, timeout=300)


def _restored(root):
    state = {"w": torch.zeros(4, dtype=torch.float64)}
    step = CheckpointManager(str(root), async_save=False).restore_latest(
        state)
    return step, state["w"].numpy()


class TestCrashMidSave:
    @pytest.mark.parametrize("point,match", [
        ("ckpt.write", {"path": "*step_00000003.tmp*"}),
        ("ckpt.before_marker", {"step": 3}),
        ("rename", {"step": 3}),
    ])
    def test_sigkill_mid_save_preserves_previous_step(self, tmp_path,
                                                      point, match):
        root = tmp_path / "ckpt"
        res = _run_worker(tmp_path, root, plan=[
            {"point": point, "action": "sigkill", **match}])
        assert res.returncode == -signal.SIGKILL, res.stderr
        assert "resume_from 0" in res.stdout
        mgr = CheckpointManager(str(root), async_save=False)
        assert mgr.latest_step() == 2
        for s in mgr.committed_steps():
            mgr.verify_step(s)
        step, w = _restored(root)
        assert step == 2 and w.tobytes() == _weights_through(2).tobytes()

    def test_relaunch_resumes_from_committed_step(self, tmp_path):
        root = tmp_path / "ckpt"
        res = _run_worker(tmp_path, root, plan=[
            {"point": "rename", "action": "sigkill", "step": 3}])
        assert res.returncode == -signal.SIGKILL, res.stderr
        res2 = _run_worker(tmp_path, root)
        assert res2.returncode == 0, res2.stdout + res2.stderr
        assert "resume_from 3" in res2.stdout
        want = _weights_through(5)
        assert "final " + " ".join(repr(float(x)) for x in want) \
            in res2.stdout

    def test_sigterm_triggers_emergency_save(self, tmp_path):
        root = tmp_path / "ckpt"
        res = _run_worker(tmp_path, root, steps=8, freq=3, plan=[
            {"point": "train.step", "action": "sigterm", "step": 4}])
        assert res.returncode == 143, (res.returncode, res.stderr)
        step, w = _restored(root)
        assert step == 3 and w.tobytes() == _weights_through(3).tobytes()

    def test_sigterm_before_first_step_saves_nothing(self, tmp_path):
        root = tmp_path / "ckpt"
        res = _run_worker(tmp_path, root, steps=6, freq=3, plan=[
            {"point": "train.step", "action": "sigterm", "step": 0}])
        assert res.returncode == 143, (res.returncode, res.stderr)
        assert CheckpointManager(str(root)).latest_step() is None


def test_resume_dir_from_env(monkeypatch):
    from paddle_tpu_torch.distributed import checkpoint_manager as cm
    monkeypatch.delenv(cm.RESUME_DIR_ENV, raising=False)
    assert cm.resume_dir_from_env("d") == "d"
    monkeypatch.setenv(cm.RESUME_DIR_ENV, "/x")
    assert cm.resume_dir_from_env() == "/x"


def test_sharded_tensor_raises_naming_a13(tmp_path):
    class DTensor(torch.Tensor):
        pass
    t = torch.zeros(2).as_subclass(DTensor)
    with pytest.raises(NotImplementedError, match="A13"):
        tckpt.save_state_dict({"w": t}, str(tmp_path))
