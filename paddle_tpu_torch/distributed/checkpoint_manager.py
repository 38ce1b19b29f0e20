"""Atomic, async checkpoints: the durable half of resumable training
(port of the reference package's ``distributed/checkpoint_manager.py``).

:class:`CheckpointManager` wraps the checkpoint format of
:mod:`~paddle_tpu_torch.distributed.checkpoint` (which writes straight
into its directory, so a crash mid-save leaves a torn checkpoint) in a
save and restore cycle that survives a crash at any point:

- **Atomic two-phase commit.** Every save writes into
  ``step_<N>.tmp/``, fsyncs data and metadata, writes a ``COMMITTED``
  marker recording each file's size and CRC-32, fsyncs again, and
  renames the directory into place. A reader never sees a half-written
  ``step_<N>/``: either the rename happened (every file durable and
  checksummed) or the directory is still ``.tmp`` and ignored. A re-save
  of a committed step swaps through a ``step_<N>.old`` aside, and
  discovery promotes an aside whose replacement never landed.
- **Async save.** ``save(..., blocking=False)`` copies the tensors to
  host memory synchronously (the train loop waits for that copy only)
  and commits from a background thread; one write is in flight at most,
  and a failed background write surfaces on the next :meth:`save` or
  :meth:`wait`.
- **Retention.** After each commit the committed steps beyond
  ``max_to_keep`` are removed (never the newest) and stale ``.tmp``
  directories are swept.
- **Discovery.** :meth:`latest_step` sees committed directories only;
  :meth:`restore_latest` verifies sizes and checksums before loading
  and falls back to the previous committed step when the newest is
  corrupt, with one flight-recorder dump per rejection.
- **Preemption.** :meth:`install_preemption_handler` hooks SIGTERM for
  one final blocking save before the process exits.

A relaunched worker finds its checkpoint root in
``PADDLE_TPU_RESUME_DIR`` (:func:`resume_dir_from_env`) and continues
from ``restore_latest(...) + 1``.

The ``checkpoint_*`` metrics and ``checkpoint.*`` spans go through
:mod:`paddle_tpu_torch.observability` and are no-ops under
``PADDLE_TPU_METRICS=0``. The fault points ``ckpt.save_begin``,
``ckpt.write``, ``ckpt.before_marker``, ``rename`` and
``ckpt.committed`` fire through :mod:`paddle_tpu_torch.testing.faults`,
so every torn-save case can be driven in a test. One process commits
into a directory.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import signal
import threading
import time
import zlib

from ..observability import metrics as _om
from ..observability.trace import span as _span
from ..testing import faults as _faults
from . import checkpoint as _ckpt

__all__ = ["CheckpointManager", "CheckpointCorruptError", "RESUME_DIR_ENV",
           "resume_dir_from_env"]

#: the env var a launcher exports so relaunched workers find their
#: checkpoint root (the reference's ``launch_elastic(resume_dir=)``,
#: ROADMAP A13)
RESUME_DIR_ENV = "PADDLE_TPU_RESUME_DIR"

#: the commit marker file inside a committed step directory
COMMITTED_MARKER = "COMMITTED"

_STEP_RE = re.compile(r"^step_(\d+)$")

#: save-duration buckets: 10ms .. 120s (large sharded writes are slow)
_SAVE_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                 10.0, 30.0, 60.0, 120.0)


def resume_dir_from_env(default=None):
    """The checkpoint root the elastic launcher handed this worker, or
    ``default``."""
    return os.environ.get(RESUME_DIR_ENV, default)


class CheckpointCorruptError(ValueError):
    """A committed step directory failed marker/size/checksum
    verification."""


def _crc32(path, chunk=1 << 20):
    acc = 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(chunk)
            if not buf:
                return acc & 0xFFFFFFFF
            acc = zlib.crc32(buf, acc)


def _fsync_dir(path):
    """Best-effort directory fsync (makes the rename itself durable on
    POSIX; some filesystems reject dir fds — never fatal)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class CheckpointManager:
    """Atomic, optionally async, retention-managed checkpoints under one
    root directory (layout: ``<root>/step_<N>/`` + ``COMMITTED``)."""

    def __init__(self, root, max_to_keep=5, async_save=True,
                 process_index=None):
        self.root = str(root)
        if max_to_keep is not None and int(max_to_keep) < 1:
            raise ValueError("max_to_keep must be >= 1 (the newest "
                             "committed step is never GC'd) or None")
        self.max_to_keep = None if max_to_keep is None else int(max_to_keep)
        self.async_save = bool(async_save)
        self.process_index = process_index
        os.makedirs(self.root, exist_ok=True)
        self._recover_aside()
        self._thread: "threading.Thread | None" = None
        self._error: "BaseException | None" = None
        self._m_saves = _om.counter(
            "checkpoint_saves_total", "checkpoint steps committed")
        self._m_save_failures = _om.counter(
            "checkpoint_save_failures_total",
            "checkpoint saves that failed before commit")
        self._m_save_seconds = _om.histogram(
            "checkpoint_save_seconds",
            "wall time of the write+commit phase",
            buckets=_SAVE_BUCKETS)
        self._m_restores = _om.counter(
            "checkpoint_restores_total", "successful checkpoint restores")
        self._m_restore_failures = _om.counter(
            "checkpoint_restore_failures_total",
            "committed steps rejected during restore "
            "(checksum/size/marker failure)")
        self._m_gc = _om.counter(
            "checkpoint_gc_removed_total",
            "committed steps removed by retention GC")
        self._m_last = _om.gauge(
            "checkpoint_last_committed_step",
            "newest step committed by this process (-1 before the first)")
        self._m_preempt = _om.counter(
            "checkpoint_preemption_saves_total",
            "emergency saves triggered by a preemption signal")

    # -- discovery ------------------------------------------------------
    def step_dir(self, step):
        return os.path.join(self.root, f"step_{int(step):08d}")

    def _recover_aside(self):
        """Heal the one crash window of a same-step re-save: a committed
        ``step_<N>`` moved aside to ``step_<N>.old`` whose replacement
        rename never happened. The aside is a complete committed step —
        promote it back; when the final exists the swap finished, so the
        aside is just garbage."""
        try:
            names = os.listdir(self.root)
        except FileNotFoundError:
            return
        for name in names:
            if not (name.endswith(".old") and _STEP_RE.match(name[:-4])):
                continue
            aside = os.path.join(self.root, name)
            final = os.path.join(self.root, name[:-4])
            if os.path.isdir(final):
                shutil.rmtree(aside, ignore_errors=True)
            else:
                os.rename(aside, final)

    def committed_steps(self):
        """Ascending step numbers whose directory holds a ``COMMITTED``
        marker (``.tmp`` and torn directories never appear here)."""
        out = []
        try:
            names = os.listdir(self.root)
        except FileNotFoundError:
            return out
        for name in names:
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.root, name,
                                                 COMMITTED_MARKER)):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self):
        """Newest committed step, or None when the root holds none."""
        steps = self.committed_steps()
        return steps[-1] if steps else None

    def next_step(self):
        """``latest_step() + 1``, or 0 on a fresh root — the step a
        resumed training loop should execute next. Prefer
        ``restore_latest(...) + 1`` when restoring: it reflects the step
        that actually loaded, even if a newer committed step was
        rejected as corrupt."""
        latest = self.latest_step()
        return 0 if latest is None else latest + 1

    # -- save -----------------------------------------------------------
    def save(self, state_dict, step, blocking=None):
        """Atomically commit ``state_dict`` as ``step``.

        Snapshots to host synchronously (the only part that blocks
        training), then writes + commits either inline
        (``blocking=True``) or in a background thread (the default when
        ``async_save``). A pending async save is joined first (one
        write is in flight at most) and any failure it raised surfaces
        here.
        """
        if blocking is None:
            blocking = not self.async_save
        self.wait()
        step = int(step)
        _faults.fire("ckpt.save_begin", step=step)
        with _span("checkpoint.snapshot", step=step):
            proc, meta, data = _ckpt.collect_state_shards(
                state_dict, self.process_index)
        if blocking:
            self._write_and_commit(step, proc, meta, data)
        else:
            t = threading.Thread(
                target=self._write_guarded, args=(step, proc, meta, data),
                name=f"ckpt-save-{step}", daemon=True)
            self._thread = t
            t.start()

    def wait(self):
        """Join the in-flight async save; re-raise its failure, if any."""
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write_guarded(self, step, proc, meta, data):
        try:
            self._write_and_commit(step, proc, meta, data)
        except BaseException as e:     # surfaces on the next save()/wait()
            self._error = e

    def _write_and_commit(self, step, proc, meta, data):
        t0 = time.perf_counter()
        try:
            with _span("checkpoint.write", step=step):
                self._commit(step, proc, meta, data)
        except BaseException as e:
            self._m_save_failures.inc()
            from ..observability import flight_recorder as _fr
            _fr.on_fatal("checkpoint_save_failed", e, step=step)
            raise
        self._m_saves.inc()
        self._m_save_seconds.observe(time.perf_counter() - t0)
        self._m_last.set(step)
        self._gc()

    def _commit(self, step, proc, meta, data):
        final = self.step_dir(step)
        tmp = final + ".tmp"
        # a stale tmp (crashed previous attempt) is replaced wholesale;
        # an existing final (re-save of the same step, e.g. an emergency
        # save of an already-committed step) stays in place until the
        # replacement is fully durable — deleting it up front would
        # reopen exactly the torn-save window this class exists to close
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        names = _ckpt.write_state_shards(tmp, proc, meta, data, fsync=True)
        files = {}
        for name in names:
            p = os.path.join(tmp, name)
            files[name] = {"size": os.path.getsize(p), "crc32": _crc32(p)}
        _faults.fire("ckpt.before_marker", step=step)
        marker_path = os.path.join(tmp, COMMITTED_MARKER)
        with open(marker_path, "w") as f:
            json.dump({"step": step, "unix_time": time.time(),
                       "files": files}, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        # the commit point: before this rename the step is invisible,
        # after it the step is complete — there is no in-between. A
        # same-step re-save swaps via an ``.old`` aside (directories
        # can't be rename-replaced atomically); the only crash window is
        # between the two renames, and _recover_aside() heals it by
        # promoting the fully-valid aside back to final.
        old = final + ".old"
        if os.path.isdir(old):
            shutil.rmtree(old)
        if os.path.isdir(final):
            os.rename(final, old)
        _faults.rename(tmp, final, step=step)
        _fsync_dir(self.root)
        if os.path.isdir(old):
            shutil.rmtree(old)
        _faults.fire("ckpt.committed", step=step)

    # -- restore --------------------------------------------------------
    def verify_step(self, step):
        """Raise :class:`CheckpointCorruptError` unless ``step``'s
        directory carries a valid marker and every recorded file matches
        its committed size and CRC-32."""
        d = self.step_dir(step)
        marker_path = os.path.join(d, COMMITTED_MARKER)
        try:
            with open(marker_path) as f:
                marker = json.load(f)
        except (OSError, ValueError) as e:
            raise CheckpointCorruptError(
                f"step {step}: unreadable commit marker: {e}") from e
        for name, rec in marker.get("files", {}).items():
            p = os.path.join(d, name)
            if not os.path.exists(p):
                raise CheckpointCorruptError(
                    f"step {step}: committed file {name!r} is missing")
            size = os.path.getsize(p)
            if size != rec["size"]:
                raise CheckpointCorruptError(
                    f"step {step}: {name!r} is {size} bytes, marker "
                    f"recorded {rec['size']}")
            crc = _crc32(p)
            if crc != rec["crc32"]:
                raise CheckpointCorruptError(
                    f"step {step}: {name!r} checksum {crc:#010x} != "
                    f"committed {rec['crc32']:#010x} (corrupt shard?)")

    def restore_latest(self, state_dict):
        """Fill ``state_dict`` in place from the newest restorable
        committed step; returns that step number.

        Uncommitted (``.tmp``/torn) directories are invisible; a
        committed step that fails checksum verification or load is
        skipped (counted + flight-recorder dump) and the previous
        committed step is tried. Returns None when the root holds no
        committed step at all; raises when committed steps exist but
        none restores.
        """
        self._recover_aside()
        steps = self.committed_steps()
        if not steps:
            return None
        last_err = None
        for step in reversed(steps):
            try:
                with _span("checkpoint.restore", step=step):
                    self.verify_step(step)
                    _ckpt.load_state_dict(state_dict, self.step_dir(step))
                self._m_restores.inc()
                return step
            except Exception as e:
                last_err = e
                self._m_restore_failures.inc()
                from ..observability import flight_recorder as _fr
                _fr.on_fatal("checkpoint_restore_failed", e, step=step,
                             root=self.root)
        raise RuntimeError(
            f"no restorable checkpoint under {self.root}: every "
            f"committed step of {steps} failed verification/load; "
            f"last error: {last_err}") from last_err

    # -- retention ------------------------------------------------------
    def _gc(self):
        """Drop committed steps beyond ``max_to_keep`` (newest always
        kept) and sweep stale ``.tmp`` directories. Runs after each
        commit, on the writer thread — never concurrent with a write,
        because saves are single-flight."""
        try:
            names = os.listdir(self.root)
        except FileNotFoundError:
            return
        self._recover_aside()
        for name in names:
            if name.endswith(".tmp") and _STEP_RE.match(name[:-4]):
                shutil.rmtree(os.path.join(self.root, name),
                              ignore_errors=True)
        if self.max_to_keep is None:
            return
        steps = self.committed_steps()
        for step in steps[:-self.max_to_keep]:
            shutil.rmtree(self.step_dir(step), ignore_errors=True)
            self._m_gc.inc()

    # -- preemption -----------------------------------------------------
    def install_preemption_handler(self, state_fn, step_fn,
                                   signals=(signal.SIGTERM,),
                                   exit_code=None):
        """Hook preemption signals (default SIGTERM, what a preemption
        notice and a launcher's teardown deliver) for ONE final blocking
        emergency save of
        ``state_fn()`` at step ``step_fn()``, then exit with
        ``exit_code`` (default ``128 + signum``, the conventional
        killed-by-signal code). A ``step_fn()`` returning None skips
        the save (nothing has completed that is worth committing —
        saving untrained initial weights would make a relaunch resume
        PAST a step that never ran).

        Must be called from the main thread (CPython signal rule).
        Returns ``{signum: previous_handler}`` so callers can restore.
        """
        prev = {}

        def _handler(signum, frame):
            step = step_fn()
            if step is not None:
                self._m_preempt.inc()
                try:
                    self.save(state_fn(), step, blocking=True)
                except Exception:
                    # exiting anyway — the failure was already counted
                    # and flight-recorded by the save path
                    pass
            os._exit(exit_code if exit_code is not None
                     else 128 + signum)

        for sig in signals:
            prev[sig] = signal.signal(sig, _handler)
        return prev
