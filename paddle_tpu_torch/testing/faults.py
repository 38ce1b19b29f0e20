"""Deterministic fault injection for crash/recovery tests (port of
``paddle_tpu/testing/faults.py``; standard library only, so the same
plans drive both packages).

Reference: the recovery model of `fleet/elastic/manager.py` (detect a
failure, relaunch, resume from checkpoint) is only provable if the
failure itself is reproducible. This module makes failures first-class
test inputs: production code calls :func:`fire` at named points
("ckpt.write", "rename", "train.step", ...) and a *fault plan* — a JSON
list of rules in the ``PADDLE_TPU_FAULTS`` environment variable —
decides, deterministically, what happens there: nothing (the default,
one dict lookup when no plan is set), a crash, a signal, a hang, a
slow-down, an injected ``OSError``, or a bit-flip of a file.

Because the plan travels through the environment, subprocess tests
activate it without patching any code: the launcher test sets
``PADDLE_TPU_FAULTS='[{"point": "rename", "step": 3, "action":
"sigkill"}]'`` and the worker under test dies mid-save of step 3,
exactly once, every run.

Rule fields (all optional except ``point`` and ``action``):

- ``point``: instrumented point name (exact match). Instrumented so
  far: the checkpoint commit path (``ckpt.write``,
  ``ckpt.before_marker``, ``rename``), the training loop
  (``train.step``), the serving request lifecycle
  (``serve.admit`` — fired per admission attempt, so a ``raise`` rule
  with ``exc: "MemoryError"`` simulates KV-pool pressure and drives
  the degradation ladder; ``serve.decode`` — fired before each
  step/burst dispatch, ``step`` = dispatch ordinal; ``serve.drain`` —
  fired as a graceful drain begins), and the multi-replica serving
  tier (``replica.dead`` — fired per replica worker-loop tick with
  ``step`` = tick ordinal and ``path`` = the replica id, so a
  ``raise``/``hang`` rule kills replica N at tick K and the router's
  membership TTL + failover path runs deterministically in CI;
  ``router.route`` — fired per routing decision with ``step`` = the
  route ordinal, so a ``raise`` rule injects routing errors;
  ``serve.spawn`` — fired in the SUPERVISOR before each replica
  spawn/restart attempt with ``path`` = the replica id and ``step`` =
  the spawn ordinal, so a ``raise`` rule deterministically fails
  process spawn — the supervisor's exponential backoff and crash-loop
  circuit breaker run without a single real process; ``replica
  .heartbeat`` — fired on the replica's heartbeat sidecar before each
  stamp refresh with ``path`` = the replica id and ``step`` = the beat
  ordinal, so a ``hang``/``sleep`` rule freezes heartbeats and the
  replica silently ages out of membership, driving TTL death detection
  and, repeated, the circuit breaker), and the host KV tier's copies
  (``tier.d2h`` / ``tier.h2d``, fired through :func:`fire_copy` per
  paused-sequence copy with ``path="seq"`` and per demoted prefix page
  with ``path="prefix"``: ``sleep`` = a slow copy, ``raise`` = a failed
  one, ``bitflip`` = a torn one). The serving engine fires
  ``serve.admit``, ``serve.decode`` and ``serve.drain``, its host tier
  ``tier.d2h`` and ``tier.h2d``.
- ``action``: one of ``crash`` (``os._exit``), ``sigkill``, ``sigterm``
  (signal self), ``hang`` (sleep ~forever), ``sleep`` (slow-down, then
  continue), ``raise`` (``OSError`` by default; see ``exc``),
  ``bitflip`` (corrupt the file at the point's ``path``).
- ``exc``: for ``raise`` — the exception type to inject, one of
  ``OSError`` (default), ``MemoryError``, ``TimeoutError``,
  ``RuntimeError``. Lets a plan exercise typed failure paths (e.g.
  admission pressure is a ``MemoryError`` contract).
- ``step``: only fire when the call site passes this step number.
- ``path``: fnmatch glob matched against the call site's path (full
  path or basename).
- ``env``: ``{name: value}`` — only fire when every named environment
  variable currently has that value (e.g. restrict a kill to elastic
  generation 0 via ``{"PADDLE_RESTART_COUNT": "0"}``).
- ``count``: fire at most this many times per process (default:
  unlimited).
- ``seconds``: duration for ``sleep`` / ``hang`` (defaults 0.1 / 3600).
- ``exit_code``: for ``crash`` (default 23).

The reference's message points (``rpc.send``, ``rpc.reply``,
``store.heartbeat``) and socket points (``store.connect``,
``store.frame``) have no call site in the port yet: their hooks
(``fire_network``, ``fire_store``) come with the modules that call them
(ROADMAP A9), and a plan rule at a message or socket point is refused at
parse time until then.

Plans are VALIDATED at parse time: an unknown rule key, an unknown
action, or a point name that no instrumented call site registers
raises a clear ``ValueError`` — a typo'd chaos plan fails loudly
instead of silently never firing.
"""

from __future__ import annotations

import fnmatch
import json
import os
import signal
import time

__all__ = ["PLAN_ENV", "FaultRule", "FaultPlan", "plan", "reset", "active",
           "fire", "fire_copy", "bitflip", "PROCESS_POINTS", "NETWORK_POINTS",
           "STORE_POINTS"]

#: environment variable holding the JSON fault plan
PLAN_ENV = "PADDLE_TPU_FAULTS"

_ACTIONS = ("crash", "sigkill", "sigterm", "hang", "sleep", "raise",
            "bitflip")

_NET_ACTIONS = ("drop", "delay", "duplicate", "reorder", "partition")

#: instrumented process points — :func:`fire` call sites. A plan naming
#: any other point is a typo and fails at parse time.
PROCESS_POINTS = frozenset({
    "ckpt.write", "ckpt.before_marker", "ckpt.save_begin",
    "ckpt.committed", "rename", "train.step", "serve.admit",
    "serve.decode", "serve.drain", "serve.spawn", "replica.dead",
    "replica.heartbeat", "router.route", "tier.d2h", "tier.h2d",
})

#: the reference's message points (``fire_network``; no call site here)
NETWORK_POINTS = frozenset({"rpc.send", "rpc.reply", "store.heartbeat"})

_STORE_ACTIONS = ("refuse", "reset", "hang", "slow", "torn")

#: the reference's socket points of the TCP control-plane store
#: (``fire_store``; no call site here)
STORE_POINTS = frozenset({"store.connect", "store.frame"})

_RULE_KEYS = frozenset({"point", "action", "step", "path", "env",
                        "count", "seconds", "exit_code", "exc"})
#: injectable exception types for ``raise`` rules — a closed set, so a
#: plan can't name arbitrary symbols
_EXC_TYPES = {"OSError": OSError, "MemoryError": MemoryError,
              "TimeoutError": TimeoutError, "RuntimeError": RuntimeError}


class FaultRule:
    """One parsed plan entry. Matching is pure; firing performs the
    action (and may not return)."""

    def __init__(self, spec):
        unknown = set(spec) - _RULE_KEYS
        if unknown:
            raise ValueError(
                f"unknown fault rule key(s) {sorted(unknown)}; expected "
                f"a subset of {sorted(_RULE_KEYS)}")
        self.point = spec["point"]
        if self.point not in PROCESS_POINTS:
            raise ValueError(
                f"unregistered fault point {self.point!r}; instrumented "
                f"points are {sorted(PROCESS_POINTS)} (network points "
                f"{sorted(NETWORK_POINTS)} take network actions "
                f"{_NET_ACTIONS}; store points {sorted(STORE_POINTS)} "
                f"take store actions {_STORE_ACTIONS})")
        self.action = spec["action"]
        if self.action not in _ACTIONS:
            raise ValueError(
                f"unknown fault action {self.action!r}; expected one of "
                f"{_ACTIONS}")
        self.step = spec.get("step")
        self.path = spec.get("path")
        self.env = spec.get("env") or {}
        self.count = spec.get("count")
        self.seconds = spec.get("seconds")
        self.exit_code = int(spec.get("exit_code", 23))
        self.exc = spec.get("exc", "OSError")
        if self.exc not in _EXC_TYPES:
            raise ValueError(
                f"unknown exc type {self.exc!r}; expected one of "
                f"{tuple(_EXC_TYPES)}")
        self.fired = 0

    def matches(self, point, step, path):
        if point != self.point:
            return False
        if self.count is not None and self.fired >= self.count:
            return False
        if self.step is not None and step != self.step:
            return False
        if self.path is not None:
            if path is None:
                return False
            if not (fnmatch.fnmatch(path, self.path)
                    or fnmatch.fnmatch(os.path.basename(path), self.path)):
                return False
        for k, v in self.env.items():
            if os.environ.get(k) != str(v):
                return False
        return True

    def perform(self, point, step, path):
        self.fired += 1
        if self.action == "crash":
            os._exit(self.exit_code)
        elif self.action == "sigkill":
            os.kill(os.getpid(), signal.SIGKILL)
            time.sleep(30)          # SIGKILL needs no handler; just wait
        elif self.action == "sigterm":
            os.kill(os.getpid(), signal.SIGTERM)
        elif self.action == "hang":
            time.sleep(self.seconds if self.seconds is not None else 3600)
        elif self.action == "sleep":
            time.sleep(self.seconds if self.seconds is not None else 0.1)
        elif self.action == "raise":
            raise _EXC_TYPES[self.exc](
                f"fault injected at {point!r}"
                + (f" step={step}" if step is not None else "")
                + (f" path={path}" if path is not None else ""))
        elif self.action == "bitflip":
            if path is None:
                raise ValueError(
                    f"bitflip rule at {point!r} fired without a path")
            bitflip(path)


class FaultPlan:
    def __init__(self, rules):
        self.rules = []
        for r in rules:
            if not isinstance(r, FaultRule) and (
                    r.get("point") in NETWORK_POINTS | STORE_POINTS):
                raise ValueError(
                    f"fault point {r['point']!r} has no call site in the "
                    "port yet: message and socket points come with "
                    "ROADMAP A9")
            self.rules.append(r if isinstance(r, FaultRule)
                              else FaultRule(r))

    def fire(self, point, step=None, path=None):
        for rule in self.rules:
            if rule.matches(point, step, path):
                rule.perform(point, step, path)

    def fire_copy(self, point, step=None, path=None):
        torn = False
        for rule in self.rules:
            if not rule.matches(point, step, path):
                continue
            if rule.action == "bitflip":
                # an in-memory copy has no file to flip: consume the
                # rule and report the tear back for the caller
                rule.fired += 1
                torn = True
            else:
                rule.perform(point, step, path)
        return torn


_plan: "FaultPlan | None" = None
_parsed = False


def plan():
    """The process fault plan parsed (once) from ``PADDLE_TPU_FAULTS``,
    or None when the variable is unset/empty."""
    global _plan, _parsed
    if not _parsed:
        raw = os.environ.get(PLAN_ENV)
        _plan = FaultPlan(json.loads(raw)) if raw else None
        _parsed = True
    return _plan


def reset():
    """Forget the cached plan so the next :func:`fire` re-reads the
    environment (test hook; also clears per-rule fire counts)."""
    global _plan, _parsed
    _plan = None
    _parsed = False


def active():
    return plan() is not None


def fire(point, step=None, path=None):
    """Instrumented-point hook: no-op (one cached-None check) without a
    plan; otherwise every matching rule performs its action in plan
    order. ``raise`` rules propagate; crash-family rules never return."""
    p = plan()
    if p is not None:
        p.fire(point, step=step, path=path)


def fire_copy(point, step=None, path=None):
    """Copy-point hook (``tier.d2h`` / ``tier.h2d``): like :func:`fire`
    for every matching rule EXCEPT ``bitflip`` — an in-flight
    device<->host copy has no file to flip, so a matching bitflip rule is
    consumed and reported back (returns True) for the CALLER to tear
    the in-memory buffer it is copying. ``sleep`` rules model a slow
    copy, ``raise`` a failed one, ``bitflip`` a torn one."""
    p = plan()
    return p.fire_copy(point, step=step, path=path) \
        if p is not None else False


def bitflip(path, offset=None, mask=0xFF):
    """Flip bits of one byte of ``path`` in place (default: the middle
    byte). The minimal storage corruption a checksum must catch."""
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"cannot bitflip empty file {path}")
    if offset is None:
        offset = size // 2
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ mask]))
        f.flush()
        os.fsync(f.fileno())
