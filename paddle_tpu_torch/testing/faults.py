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

Network rules: a rule whose ``action`` is one of ``drop`` /
``delay`` / ``duplicate`` / ``reorder`` / ``partition`` is a
:class:`NetworkRule` — it fires at MESSAGE points (``rpc.send``,
``rpc.reply``, ``store.heartbeat``) via :func:`fire_network`, matched
by the ``(src, dst)`` name pair (fnmatch globs), and returns a
:class:`NetworkVerdict` the transport interprets instead of performing
a process action:

- ``drop``: the message is lost — the caller sees a timeout and (with
  at-least-once rpc) retries.
- ``delay``: the message is held ``seconds`` before it is handed to
  the transport (in-flight latency).
- ``duplicate``: the message is delivered ``copies`` extra times — the
  receiver's dedup cache must make redelivery exactly-once-effective.
- ``reorder``: the message's mailbox slot is claimed, then held for a
  seeded-random fraction of ``seconds`` before the payload lands — in
  a sequential mailbox transport true reorder degenerates to
  head-of-line delay, which is what this injects.
- ``partition``: every matching message is dropped for a wall-clock
  window of ``seconds`` (default 1.0) measured from the rule's first
  match — a full network partition between the matched pair.

Extra network-rule fields: ``src`` / ``dst`` (fnmatch globs on the
endpoint names), ``p`` (per-message fire probability, drawn from a
rule-local ``random.Random(seed)`` so a seeded chaos schedule replays
identically), ``seed``, ``copies``.

Store rules: a rule whose ``point`` is a SOCKET point of
the TCP control-plane store (``store.connect`` — fired per connection
attempt of a :class:`~paddle_tpu_torch.distributed.net_store.LeaseStore`
client, ``path`` = the server address; ``store.frame`` — fired per
request frame, ``path`` = the op name, ``step`` = the client's op
ordinal) is a :class:`StoreRule` — it fires via :func:`fire_store` and
returns a :class:`StoreVerdict` the CLIENT interprets (so seeded
chaos stays deterministic regardless of server threading):

- ``refuse``: the connection is refused (``ConnectionRefusedError``) —
  the server port is closed.
- ``reset``: the socket is reset mid-operation
  (``ConnectionResetError``) — the server died under the client.
- ``hang``: the operation blocks ``seconds`` (default 1.0), then times
  out — a black-holed route.
- ``slow``: the operation is delayed ``seconds`` (default 0.05), then
  proceeds — a congested link.
- ``torn``: the frame arrives truncated — the client must treat it as
  a transport failure, never decode garbage.

Store rules take the same ``p``/``seed``/``count``/``step``/``path``/
``env`` fields as network rules; every store-client failure they
induce surfaces as a typed ``StoreUnavailableError`` through the
normal retry/reconnect machinery.

Plans are VALIDATED at parse time: an unknown rule key, an unknown
action, or a point name that no instrumented call site registers
raises a clear ``ValueError`` — a typo'd chaos plan fails loudly
instead of silently never firing.
"""

from __future__ import annotations

import fnmatch
import json
import os
import random
import signal
import threading
import time

__all__ = ["PLAN_ENV", "FaultRule", "NetworkRule", "NetworkVerdict",
           "StoreRule", "StoreVerdict", "FaultPlan", "plan", "reset",
           "active", "fire", "fire_copy", "fire_network", "fire_store",
           "rename", "bitflip", "PROCESS_POINTS", "NETWORK_POINTS",
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

#: instrumented message points — :func:`fire_network` call sites
NETWORK_POINTS = frozenset({"rpc.send", "rpc.reply", "store.heartbeat"})

_STORE_ACTIONS = ("refuse", "reset", "hang", "slow", "torn")

#: instrumented socket points of the TCP control-plane store —
#: :func:`fire_store` call sites (client side, for determinism)
STORE_POINTS = frozenset({"store.connect", "store.frame"})

_RULE_KEYS = frozenset({"point", "action", "step", "path", "env",
                        "count", "seconds", "exit_code", "exc"})
_NET_RULE_KEYS = frozenset({"point", "action", "src", "dst", "p",
                            "seed", "count", "step", "seconds",
                            "copies", "env"})
_STORE_RULE_KEYS = frozenset({"point", "action", "step", "path", "p",
                              "seed", "count", "seconds", "env"})

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


class NetworkVerdict:
    """What the matching network rules decided for ONE message. The
    transport interprets it: ``drop`` — never send (the caller times
    out); ``delay`` — sleep this long before handing the message to the
    transport; ``hold`` — claim the mailbox slot first, THEN sleep this
    long before the payload lands (reorder's head-of-line shape);
    ``copies`` — deliver this many extra copies."""

    __slots__ = ("drop", "delay", "hold", "copies")

    def __init__(self):
        self.drop = False
        self.delay = 0.0
        self.hold = 0.0
        self.copies = 0

    def __bool__(self):
        return self.drop or self.delay > 0 or self.hold > 0 \
            or self.copies > 0

    def __repr__(self):
        return (f"NetworkVerdict(drop={self.drop}, delay={self.delay}, "
                f"hold={self.hold}, copies={self.copies})")


#: shared falsy verdict returned when no rule matched (never mutated)
_NO_VERDICT = NetworkVerdict()


class NetworkRule:
    """One parsed network-plan entry. Matching is pure except for the
    rule-local seeded RNG draw (``p``) and the partition window clock;
    the verdict is applied by the transport, not here."""

    def __init__(self, spec):
        unknown = set(spec) - _NET_RULE_KEYS
        if unknown:
            raise ValueError(
                f"unknown network fault rule key(s) {sorted(unknown)}; "
                f"expected a subset of {sorted(_NET_RULE_KEYS)}")
        self.point = spec["point"]
        if self.point not in NETWORK_POINTS:
            raise ValueError(
                f"unregistered network fault point {self.point!r}; "
                f"instrumented message points are "
                f"{sorted(NETWORK_POINTS)}")
        self.action = spec["action"]
        if self.action not in _NET_ACTIONS:
            raise ValueError(
                f"unknown network fault action {self.action!r}; "
                f"expected one of {_NET_ACTIONS}")
        self.src = spec.get("src")
        self.dst = spec.get("dst")
        self.p = float(spec.get("p", 1.0))
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"network rule p={self.p} outside [0, 1]")
        self.seed = int(spec.get("seed", 0))
        self.count = spec.get("count")
        self.step = spec.get("step")
        self.seconds = spec.get("seconds")
        self.copies = int(spec.get("copies", 1))
        self.env = spec.get("env") or {}
        self._rng = random.Random(self.seed)
        self._window_start = None       # partition: first-match stamp
        self.fired = 0

    def _endpoint_match(self, pattern, name):
        if pattern is None:
            return True
        if name is None:
            return False
        return fnmatch.fnmatch(str(name), pattern)

    def matches(self, point, src, dst, step):
        if point != self.point:
            return False
        if not (self._endpoint_match(self.src, src)
                and self._endpoint_match(self.dst, dst)):
            return False
        if self.step is not None and step != self.step:
            return False
        for k, v in self.env.items():
            if os.environ.get(k) != str(v):
                return False
        if self.action == "partition":
            # window semantics: active for `seconds` of wall clock from
            # the FIRST match; p/count do not apply — a partition drops
            # everything it sees while it lasts
            now = time.monotonic()
            if self._window_start is None:
                self._window_start = now
            return now - self._window_start \
                < (self.seconds if self.seconds is not None else 1.0)
        if self.count is not None and self.fired >= self.count:
            return False
        if self.p < 1.0 and self._rng.random() >= self.p:
            return False
        return True

    def apply(self, verdict):
        self.fired += 1
        if self.action in ("drop", "partition"):
            verdict.drop = True
        elif self.action == "delay":
            verdict.delay += self.seconds if self.seconds is not None \
                else 0.05
        elif self.action == "duplicate":
            verdict.copies += self.copies
        elif self.action == "reorder":
            verdict.hold += self._rng.uniform(
                0.0, self.seconds if self.seconds is not None else 0.2)
        return verdict


class StoreVerdict:
    """What the matching store rules decided for ONE socket operation.
    The CLIENT interprets it (see the module docstring): ``slow`` /
    ``hang`` are seconds to sleep (hang then raises a timeout),
    ``refuse`` / ``reset`` / ``torn`` are the typed failure to
    simulate."""

    __slots__ = ("refuse", "reset", "hang", "slow", "torn")

    def __init__(self):
        self.refuse = False
        self.reset = False
        self.hang = 0.0
        self.slow = 0.0
        self.torn = False

    def __bool__(self):
        return self.refuse or self.reset or self.torn \
            or self.hang > 0 or self.slow > 0

    def __repr__(self):
        return (f"StoreVerdict(refuse={self.refuse}, "
                f"reset={self.reset}, hang={self.hang}, "
                f"slow={self.slow}, torn={self.torn})")


#: shared falsy verdict returned when no store rule matched
_NO_STORE_VERDICT = StoreVerdict()


class StoreRule:
    """One parsed store-socket plan entry (points ``store.connect`` /
    ``store.frame``). Matching mirrors :class:`NetworkRule`'s seeded
    determinism; the verdict is applied by the store client."""

    def __init__(self, spec):
        unknown = set(spec) - _STORE_RULE_KEYS
        if unknown:
            raise ValueError(
                f"unknown store fault rule key(s) {sorted(unknown)}; "
                f"expected a subset of {sorted(_STORE_RULE_KEYS)}")
        self.point = spec["point"]
        if self.point not in STORE_POINTS:
            raise ValueError(
                f"unregistered store fault point {self.point!r}; "
                f"instrumented socket points are "
                f"{sorted(STORE_POINTS)}")
        self.action = spec["action"]
        if self.action not in _STORE_ACTIONS:
            raise ValueError(
                f"unknown store fault action {self.action!r}; "
                f"expected one of {_STORE_ACTIONS}")
        self.step = spec.get("step")
        self.path = spec.get("path")
        self.p = float(spec.get("p", 1.0))
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"store rule p={self.p} outside [0, 1]")
        self.seed = int(spec.get("seed", 0))
        self.count = spec.get("count")
        self.seconds = spec.get("seconds")
        self.env = spec.get("env") or {}
        self._rng = random.Random(self.seed)
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
            if not fnmatch.fnmatch(str(path), self.path):
                return False
        for k, v in self.env.items():
            if os.environ.get(k) != str(v):
                return False
        if self.p < 1.0 and self._rng.random() >= self.p:
            return False
        return True

    def apply(self, verdict):
        self.fired += 1
        if self.action == "refuse":
            verdict.refuse = True
        elif self.action == "reset":
            verdict.reset = True
        elif self.action == "hang":
            verdict.hang += self.seconds if self.seconds is not None \
                else 1.0
        elif self.action == "slow":
            verdict.slow += self.seconds if self.seconds is not None \
                else 0.05
        elif self.action == "torn":
            verdict.torn = True
        return verdict


class FaultPlan:
    def __init__(self, rules):
        self.rules = []
        self.net_rules = []
        self.store_rules = []
        # network matching mutates rule state (count, seeded rng,
        # partition window) and is called from concurrent rpc driver
        # threads and heartbeat sidecars: serialize it, or a count=1
        # rule fires twice and seeded replays stop being deterministic
        self._net_lock = threading.Lock()
        for r in rules:
            if isinstance(r, (FaultRule, NetworkRule, StoreRule)):
                rule = r
            elif r.get("point") in STORE_POINTS:
                # socket points take store actions only — routed by
                # point, since "hang" is also a process action
                rule = StoreRule(r)
            elif r.get("action") in _NET_ACTIONS:
                rule = NetworkRule(r)
            else:
                rule = FaultRule(r)
            if isinstance(rule, NetworkRule):
                self.net_rules.append(rule)
            elif isinstance(rule, StoreRule):
                self.store_rules.append(rule)
            else:
                self.rules.append(rule)

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

    def fire_network(self, point, src=None, dst=None, step=None):
        verdict = None
        with self._net_lock:
            for rule in self.net_rules:
                if rule.matches(point, src, dst, step):
                    verdict = rule.apply(verdict or NetworkVerdict())
        return verdict if verdict is not None else _NO_VERDICT

    def fire_store(self, point, step=None, path=None):
        verdict = None
        with self._net_lock:
            for rule in self.store_rules:
                if rule.matches(point, step, path):
                    verdict = rule.apply(verdict or StoreVerdict())
        return verdict if verdict is not None else _NO_STORE_VERDICT


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


def fire_network(point, src=None, dst=None, step=None):
    """Message-point hook: returns the merged :class:`NetworkVerdict`
    of every matching network rule (a shared falsy verdict without a
    plan — one cached-None check on the hot path). The TRANSPORT
    applies the verdict; this function never sleeps or raises."""
    p = plan()
    if p is None:
        return _NO_VERDICT
    return p.fire_network(point, src=src, dst=dst, step=step)


def fire_store(point, step=None, path=None):
    """Socket-point hook (``store.connect`` / ``store.frame``):
    returns the merged :class:`StoreVerdict` of every matching store
    rule (a shared falsy verdict without a plan — one cached-None
    check on the hot path). The store CLIENT applies the verdict —
    sleeping for ``slow``/``hang`` and raising the typed connection
    failure — so every injected fault flows through the same
    retry/reconnect machinery a real one would."""
    p = plan()
    if p is None:
        return _NO_STORE_VERDICT
    return p.fire_store(point, step=step, path=path)


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


def rename(src, dst, step=None):
    """``os.rename`` with an injection point in front: a plan rule at
    point ``"rename"`` can delay (``sleep``), fail (``raise``), or kill
    the process (``sigkill``/``crash``) before the rename happens: the
    torn-commit cases an atomic checkpoint must survive."""
    fire("rename", step=step, path=dst)
    os.rename(src, dst)
