"""The port's AMP debugging tools against the reference package's
``amp/debugging.py``: operator stats (per-op dtype columns, the table,
the returned dict), the dispatch seam installed only while needed, the
tensor checker (its raise and message, its skips), ``check_numerics``
(counts, counter, flight recorder), ``compare_accuracy`` and the flag
registry.

Inputs are seeded numpy arrays. Tolerances: counts, messages, tables and
flags exact; ``compare_accuracy``'s report within 1e-6 (elementwise ops,
correctly rounded in both libraries).
"""

import collections
import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes

import paddle_tpu as paddle
from paddle_tpu import flags as jflags
from paddle_tpu.amp import debugging as jd

from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import jit
from paddle_tpu_torch.amp import auto_cast, debugging as td
from paddle_tpu_torch.framework import dispatch
from paddle_tpu_torch.incubate.nn import functional as FI
from paddle_tpu_torch.observability import flight_recorder as ofr
from paddle_tpu_torch.observability import metrics as om

torch.set_num_threads(1)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture(autouse=True)
def _clean():
    yield
    td.disable_tensor_checker()
    jflags.set_flags({"FLAGS_check_nan_inf": False})
    td._op_stats = None
    dispatch.observers.clear()
    dispatch.sync()
    ofr.uninstall()


def _arrays(*shapes, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def _quiet(fn):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        res = fn()
    return res, out.getvalue()


def _other(dtype):
    """A cast target other than ``dtype`` (a same-dtype cast is no op in
    torch)."""
    return "bfloat16" if dtype == "float32" else "float32"


# op: (reference op, port op, reference call, port call)
_CASES = {
    "matmul": ("matmul", "mm", lambda a, b, w: paddle.matmul(a, b),
               lambda a, b, w: torch.matmul(a, b)),
    "add": ("add", "add", lambda a, b, w: a + a, lambda a, b, w: a + a),
    "softmax": ("softmax", "_softmax",
                lambda a, b, w: paddle.nn.functional.softmax(a),
                lambda a, b, w: torch.softmax(a, -1)),
    "rms_norm": ("rms_norm", "rms_norm",
                 lambda a, b, w: paddle.nn.functional.rms_norm(a, w),
                 lambda a, b, w: FI.rms_norm(a, w)),
    "cast": ("cast", "_to_copy",
             lambda a, b, w: a.astype(_other(str(a.dtype).split(".")[-1])),
             lambda a, b, w: a.to(getattr(torch, _other(
                 str(a.dtype).split(".")[-1])))),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("op", sorted(_CASES))
def test_single_op_dtype_columns_match_reference(op, dtype):
    jname, tname, jcall, tcall = _CASES[op]
    a, b, w = _arrays((4, 8), (8, 3), (8,))
    ja, jb = (paddle.to_tensor(x).astype(dtype) for x in (a, b))
    jw = paddle.to_tensor(w)
    ta, tb = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in (a, b))
    tw = torch.from_numpy(w)
    jd.enable_operator_stats_collection()
    jcall(ja, jb, jw)
    want, _ = _quiet(jd.disable_operator_stats_collection)
    td.enable_operator_stats_collection()
    tcall(ta, tb, tw)
    got, _ = _quiet(td.disable_operator_stats_collection)
    assert list(want) == [jname] and list(got) == [tname]
    assert got[tname] == want[jname]


def test_matmul_under_o1_matches_reference():
    """Under bf16 ``auto_cast`` the matmul's column is bf16 in both; the
    port's seam also sees the two casts autocast inserts below it."""
    a, b = _arrays((4, 8), (8, 3))
    ja, jb = paddle.to_tensor(a), paddle.to_tensor(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    jd.enable_operator_stats_collection()
    with paddle.amp.auto_cast(dtype="bfloat16"):
        paddle.matmul(ja, jb)
    want, _ = _quiet(jd.disable_operator_stats_collection)
    td.enable_operator_stats_collection()
    with auto_cast(dtype="bfloat16"):
        torch.matmul(ta, tb)
    got, _ = _quiet(td.disable_operator_stats_collection)
    assert got["mm"] == want["matmul"] == {"fp16": 0, "bf16": 1,
                                           "fp32": 0, "other": 0}
    assert set(got) == {"mm", "_to_copy"}
    assert got["_to_copy"]["bf16"] == 2


def test_table_and_dict_layout_match_reference():
    """The printed table (header, footer, widths, sorted names) and the
    returned dict are the reference's for the same counts."""
    a, b, w = _arrays((4, 8), (8, 3), (8,))
    ta, tb, tw = map(torch.from_numpy, (a, b, w))
    td.enable_operator_stats_collection()
    with auto_cast(dtype="bfloat16"):
        y = torch.matmul(ta, tb)
    FI.rms_norm(ta, tw)
    torch.softmax(y.float(), -1)
    got, table = _quiet(td.disable_operator_stats_collection)
    assert isinstance(got, dict) and all(
        set(v) == {"fp16", "bf16", "fp32", "other"} for v in got.values())
    jd._op_stats = collections.defaultdict(
        lambda: {"fp16": 0, "bf16": 0, "fp32": 0, "other": 0}, got)
    want, want_table = _quiet(jd.disable_operator_stats_collection)
    assert table == want_table and want == got
    assert table.splitlines()[1].split() == ["op", "fp16", "bf16", "fp32",
                                             "other"]
    assert td.disable_operator_stats_collection() == {}


def test_the_seam_is_installed_only_while_needed():
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    assert not dispatch.installed()
    assert not _get_current_dispatch_mode_stack()
    with contextlib.redirect_stdout(io.StringIO()):
        with td.collect_operator_stats():
            assert dispatch.installed()
            td.enable_tensor_checker()
        assert dispatch.installed()          # the checker still needs it
        td.disable_tensor_checker()
    assert not dispatch.installed()
    assert not _get_current_dispatch_mode_stack()
    # the flag set directly installs it too, as the reference's flag is
    # read by its executor
    tflags.set_flags({"FLAGS_check_nan_inf": "1"})
    assert dispatch.installed() and tflags.flag("check_nan_inf") is True
    tflags.set_flags({"check_nan_inf": False})
    assert not dispatch.installed()


def test_backward_ops_are_counted():
    """A stated difference: the seam sees the backward's ops too."""
    a, b = _arrays((4, 8), (8, 3))
    x = torch.from_numpy(a).requires_grad_()
    td.enable_operator_stats_collection()
    (x @ torch.from_numpy(b)).sum().backward()
    got, _ = _quiet(td.disable_operator_stats_collection)
    assert got["mm"]["fp32"] == 2            # the forward's and dx's


def test_port_ops_count_once_under_their_reference_name():
    """A kernel wrapper (here the fused cross-entropy, on its plain
    version on the CPU) is one op; its inner aten ops are not seen."""
    from paddle_tpu_torch.ops.fused_linear_cross_entropy import \
        fused_linear_cross_entropy
    h, w = _arrays((6, 8), (16, 8))
    labels = torch.tensor([1, 2, 3, 4, 5, -100])
    td.enable_operator_stats_collection()
    fused_linear_cross_entropy(torch.from_numpy(h), torch.from_numpy(w),
                               labels)
    got, _ = _quiet(td.disable_operator_stats_collection)
    assert got["fused_linear_cross_entropy"]["fp32"] == 1
    assert "mm" not in got and "logsumexp" not in got


def test_checker_raises_the_reference_message():
    (a,) = _arrays((4, 8))
    td.enable_tensor_checker()
    with pytest.raises(FloatingPointError) as got:
        torch.log(-torch.from_numpy(np.abs(a)))
    paddle.set_flags({"FLAGS_check_nan_inf": True})
    with pytest.raises(FloatingPointError) as want:
        paddle.log(-paddle.to_tensor(np.abs(a)))
    assert str(got.value) == str(want.value)
    # a port op names itself: an Inf in a layer's input surfaces at the
    # first op that outputs it
    td.disable_tensor_checker()
    bad = torch.from_numpy(a)
    bad[1, 2] = float("inf")
    td.enable_tensor_checker()
    with pytest.raises(FloatingPointError, match="'rms_norm'"):
        FI.rms_norm(bad, torch.ones(8))
    td.disable_tensor_checker()
    FI.rms_norm(bad, torch.ones(8))          # off: no raise


def test_checker_skips_compiled_steps_and_captures(monkeypatch):
    """Inside a compiled step (the reference's trace) and under a CUDA
    graph capture the checker reads nothing."""
    td.enable_tensor_checker()

    def step(x):
        return torch.log(x)

    compiled = jit.to_static(step, warmup="once")
    compiled(torch.ones(4))                  # the eager warm-up: checked
    out = compiled(torch.zeros(4))           # compiled: not checked
    assert torch.isinf(out).all()
    with pytest.raises(FloatingPointError):
        step(torch.zeros(4))                 # eager: checked
    jstep = paddle.jit.to_static(lambda x: paddle.log(x), warmup="once")
    paddle.set_flags({"FLAGS_check_nan_inf": True})
    jstep(paddle.to_tensor(np.ones(4, np.float32)))
    assert np.isinf(jstep(paddle.to_tensor(np.zeros(4, np.float32)))
                    .numpy()).all()
    # a capture in progress: no isfinite, no host read
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    calls = []
    monkeypatch.setattr(torch, "isfinite",
                        lambda *a: calls.append(a) or 1 / 0)
    assert torch.isinf(step(torch.zeros(4))).all()
    assert calls == []


def test_checker_skips_uninitialized_outputs():
    """An op that hands out unwritten memory (``empty`` and its kin) is
    not read: its bits are the allocator's, NaN as often as not, and the
    reference has no such op. The first op that writes the memory is."""
    nan = torch.full((256,), float("nan"))
    for name in ("empty", "empty_like", "empty_strided", "new_empty"):
        dispatch.check_outputs(name, (nan,))
    with pytest.raises(FloatingPointError, match="'add'"):
        dispatch.check_outputs("add", (nan,))
    td.enable_tensor_checker()
    for _ in range(8):
        with _disable_current_modes():       # NaN memory, freed unseen
            freed = torch.full((256,), float("nan"))
        del freed
        out = torch.empty(256)
        torch.empty_like(out)
        out.new_empty((256,))
        torch.empty_strided((16, 16), (16, 1))
    with pytest.raises(FloatingPointError, match="'fill_'"):
        out.fill_(float("nan"))


def test_check_numerics_counts_counter_and_flight_recorder(tmp_path):
    a = np.arange(20, dtype=np.float32)
    a[[1, 4, 9]] = np.nan
    a[[2, 7]] = [np.inf, -np.inf]
    ofr.install(log_dir=str(tmp_path))
    fam = om.counter("paddle_tpu_nan_inf_detected_total", "",
                     labelnames=("op", "var"))
    before = fam.labels("matmul", "x").value
    got, line = _quiet(lambda: td.check_numerics(torch.from_numpy(a),
                                                 "matmul", "x"))
    want, want_line = _quiet(lambda: jd.check_numerics(
        paddle.to_tensor(a), "matmul", "x"))
    assert got == want == (3, 2)
    assert all(type(v) is int for v in got)
    assert line == want_line
    assert fam.labels("matmul", "x").value == before + 1
    dumps = [d for d in os.listdir(tmp_path) if os.path.isdir(tmp_path / d)]
    assert len(dumps) == 1
    assert td.check_numerics(torch.ones(3)) == (0, 0)
    assert td.check_numerics(torch.arange(3)) == (0, 0)


def test_compare_accuracy_matches_reference():
    a, b = _arrays((5, 7), (5, 7), seed=3)

    def jfn(x, y):
        return x * y + x, x - y

    want = jd.compare_accuracy(jfn, [paddle.to_tensor(a),
                                     paddle.to_tensor(b)],
                               dtypes=("float32", "bfloat16", "float16"))
    got = td.compare_accuracy(jfn, [torch.from_numpy(a),
                                    torch.from_numpy(b)],
                              dtypes=("float32", "bfloat16", "float16"))
    assert list(got) == list(want) == ["bfloat16", "float16"]
    for dt in want:
        assert len(got[dt]) == len(want[dt]) == 2
        for g, w in zip(got[dt], want[dt]):
            assert set(g) == {"max_abs_err", "max_rel_err"}
            for k in w:
                assert abs(g[k] - w[k]) <= 1e-6 * max(1.0, abs(w[k])), k


def test_flag_registry_matches_reference():
    assert list(tflags._REGISTRY) == list(jflags._REGISTRY)
    for name, f in jflags._REGISTRY.items():
        assert tflags._REGISTRY[name].default == f.default, name
        assert tflags._REGISTRY[name].type is f.type, name
    assert sorted(tflags.get_flags()) == sorted(jflags.get_flags())
    for text, typ in [("1", bool), ("YES", bool), ("on", bool),
                      ("off", bool), ("0", bool), ("7", int),
                      ("0.25", float), ("label", str)]:
        assert tflags._parse(text, typ) == jflags._parse(text, typ)
    with pytest.raises(KeyError):
        tflags.set_flags({"FLAGS_no_such_flag": 1})
    with pytest.raises(KeyError):
        tflags.get_flags("no_such_flag")
    with pytest.raises(KeyError):
        tflags.define_flag("benchmark", True)


def test_flags_from_the_environment():
    """``FLAGS_<name>`` seeds a flag at definition; ``FLAGS_check_nan_inf``
    installs the seam when the debugging module loads."""
    code = ("from paddle_tpu_torch import flags\n"
            "from paddle_tpu_torch.amp import debugging\n"
            "from paddle_tpu_torch.framework import dispatch\n"
            "print(flags.get_flags(['check_nan_inf', 'benchmark',"
            " 'comm_timeout_seconds', 'allocator_strategy']),"
            " dispatch.installed())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, FLAGS_check_nan_inf="true",
               FLAGS_benchmark="0", FLAGS_comm_timeout_seconds="60",
               FLAGS_allocator_strategy="naive_best_fit")
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == (
        "{'FLAGS_check_nan_inf': True, 'FLAGS_benchmark': False, "
        "'FLAGS_comm_timeout_seconds': 60, "
        "'FLAGS_allocator_strategy': 'naive_best_fit'} True")
