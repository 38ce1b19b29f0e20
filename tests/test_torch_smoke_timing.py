"""``chip_smoke.device_ms_by_kernel`` on made-up profiler windows: the
per-call device time of each name from the records the profiler kept,
when it kept them all and when it left out some call's records, and the
failure when a window holds no record twice. Runs on the CPU: the
profiler window and its records are replaced by lists of fake events."""

import contextlib
import types

import pytest
import torch

import chip_smoke as cs

# One intra-op thread a process: the suite runs in parallel worker
# processes (xdist), and OpenMP threads that spin for a core each
# slow every small CPU op of the port many times over.
torch.set_num_threads(1)

ITERS = 5


def window(**records):
    """A window's device records: ``name=(count, us each)``."""
    return [types.SimpleNamespace(
        name=name, device_type=torch.autograd.DeviceType.CUDA,
        time_range=types.SimpleNamespace(start=0.0, end=us))
        for name, (n, us) in records.items() for _ in range(n)]


@pytest.fixture
def windows(monkeypatch):
    queue = []

    @contextlib.contextmanager
    def fake():
        yield queue.pop(0)
    monkeypatch.setattr(cs, "profiled", fake)
    monkeypatch.setattr(cs, "device_events", lambda prof: prof)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    return queue


@pytest.mark.parametrize("given, want", [
    # every call recorded: the first window is read
    ([window(k=(5, 200.0), c=(10, 50.0))], {"k": 0.2, "c": 0.1}),
    # one call's records left out of the first window, none of the second
    ([window(r=(4, 10.0), k=(5, 200.0)), window(r=(5, 20.0), k=(5, 100.0))],
     {"r": 0.02, "k": 0.1}),
    # a call left out of both windows (the H100's phase 10): the fuller
    # window's mean record times the launches a call
    ([window(r=(4, 10.0), h=(4, 2.0), k=(4, 200.0)),
      window(r=(4, 10.0), h=(4, 2.0), k=(5, 200.0), c=(9, 50.0))],
     {"r": 0.01, "h": 0.002, "k": 0.2, "c": 0.1}),
    # an empty first window is measured again
    ([[], window(k=(5, 300.0))], {"k": 0.3}),
], ids=["whole", "short-then-whole", "short-twice", "empty-then-whole"])
def test_device_ms_from_the_records_kept(windows, given, want):
    windows.extend(given)
    got = cs.device_ms_by_kernel(lambda: None, ITERS)
    assert set(got) == set(want)
    for name, ms in want.items():
        assert got[name] == pytest.approx(ms, rel=1e-12), name
    assert not windows    # a window with a call left out is taken again


def test_device_ms_fails_on_two_empty_windows(windows, capsys):
    windows.extend([[], []])
    with pytest.raises(SystemExit) as exc:
        cs.device_ms_by_kernel(lambda: None, ITERS)
    assert exc.value.code == 1
    assert "no device time to report" in capsys.readouterr().err
