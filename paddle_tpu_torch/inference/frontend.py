"""OpenAI-compatible HTTP front door for the serving stack.

The engine/cluster tiers (PRs 4-11) end at Python objects; real
traffic arrives as HTTP. This module is the network layer:

- ``POST /v1/completions`` and ``POST /v1/chat/completions`` —
  OpenAI-compatible request/response shapes, including SSE streaming
  (``"stream": true`` pushes a chunk per emitted token from a
  per-request emit queue and finishes with ``data: [DONE]``).
- ``GET /v1/models`` plus the standard probes (``/metrics``,
  ``/healthz``, ``/readyz``) — all on ONE
  :class:`~paddle_tpu_torch.observability.export.HttpService`.
- Fronts either a single :class:`LlamaServingEngine` (wrapped in a
  local :class:`~paddle_tpu_torch.inference.cluster.EngineReplica` worker so
  the engine has a driver thread) or a whole
  :class:`~paddle_tpu_torch.inference.cluster.ServingCluster` — request
  fields map onto :class:`ClusterRequest` (``timeout`` -> cluster
  deadline, ``max_tokens``, tenant class -> ladder ``priority``).
- Typed errors map onto proper HTTP codes:

  ==========================  ====================================
  typed error                 HTTP
  ==========================  ====================================
  ``ValueError`` (validation) 400 ``invalid_request_error``
  ``AdmissionError``          429 + ``Retry-After`` (from the
                              error's ``retry_after`` estimate)
  ``DeadlineExceeded``        504 ``timeout``
  replica/transport loss      502 ``upstream_error``
  client disconnect           (no reply possible) — tallied as 499,
                              the in-flight request is cancelled so
                              its KV pages return to the allocator
  anything else               500 ``server_error``
  ==========================  ====================================

- Multi-tenant QoS: give the frontend a
  :class:`~paddle_tpu_torch.inference.qos.QosGate` and every request is
  gated per tenant (``X-Tenant`` header, or the OpenAI ``user``
  field) BEFORE touching the router: rate-exhausted tenants get 429 +
  ``Retry-After``; admitted ones ride the gate's priority class into
  the engine's degradation ladder, and completed tokens settle back
  into the tenant's bucket with TTFT/TPOT SLO accounting.

Strings need a tokenizer (``encode(str) -> ids`` / ``decode(ids) ->
str``); :class:`ByteTokenizer` is the dependency-free default, and
token-id arrays are always accepted for ``prompt`` (the OpenAI
completions API's token-array form).
"""

from __future__ import annotations

import collections
import json
import queue
import threading
import time
import uuid

from ..observability import metrics as _om
from ..observability import tracing as _tracing
from ..observability.export import (ClientDisconnected, HttpService,
                                    add_probe_routes)
from ..observability.trace import span as _span
from .sampling import SamplingParams
from .serving import AdmissionError, DeadlineExceeded

__all__ = ["ServingFrontend", "ByteTokenizer"]

_LAT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _frontend_metrics():
    return {
        "requests": _om.counter(
            "frontend_requests_total",
            "HTTP requests by endpoint and status code (499 = client "
            "disconnected mid-response)",
            labelnames=("endpoint", "code")),
        "latency": _om.histogram(
            "frontend_request_seconds",
            "wall time from request parse to final byte",
            labelnames=("endpoint",), buckets=_LAT_BUCKETS),
        "ttft": _om.histogram(
            "frontend_ttft_seconds",
            "submit -> first token observed at the HTTP layer",
            buckets=_LAT_BUCKETS),
        "streams": _om.counter(
            "frontend_streams_total", "SSE streaming responses opened"),
        "stream_tokens": _om.counter(
            "frontend_streamed_tokens_total",
            "tokens delivered over SSE streams"),
        "disconnects": _om.counter(
            "frontend_client_disconnects_total",
            "client disconnects that cancelled an in-flight request "
            "(the 499 path)"),
    }


class ByteTokenizer:
    """Dependency-free UTF-8 byte-level tokenizer: token id ==
    byte value + ``offset``. Good enough to demo/chat against models
    whose vocab covers the byte range; swap in a real tokenizer object
    (``encode``/``decode``) for production vocabularies."""

    def __init__(self, offset=0, vocab_size=None):
        self.offset = int(offset)
        self.vocab_size = vocab_size

    def encode(self, text):
        ids = [self.offset + b for b in str(text).encode("utf-8")]
        if self.vocab_size is not None:
            bad = [t for t in ids if not 0 <= t < self.vocab_size]
            if bad:
                raise ValueError(
                    f"text encodes to token ids outside the model "
                    f"vocab (first offender {bad[0]}, vocab "
                    f"{self.vocab_size})")
        return ids

    def decode(self, ids):
        bs = bytes(max(0, min(255, int(t) - self.offset)) for t in ids)
        return bs.decode("utf-8", errors="replace")


def _error_payload(status, message, etype):
    return status, {"error": {"message": message, "type": etype,
                              "code": status}}


def _map_error(err):
    """(status, body) for a typed terminal error."""
    if isinstance(err, AdmissionError):
        return _error_payload(
            429, f"capacity: {err}", "rate_limit_exceeded")
    if isinstance(err, DeadlineExceeded):
        return _error_payload(504, str(err), "timeout")
    if isinstance(err, ValueError):
        return _error_payload(400, str(err), "invalid_request_error")
    if isinstance(err, (ConnectionError, OSError)):
        return _error_payload(502, str(err), "upstream_error")
    return _error_payload(
        500, f"{type(err).__name__}: {err}", "server_error")


class ServingFrontend:
    """The HTTP door. Construct over ``engine=`` (a single
    :class:`LlamaServingEngine` — a local worker thread drives it) or
    ``cluster=`` (a started :class:`ServingCluster`), then
    ``start(port=...)``.

    Args:
        engine / cluster: exactly one backend.
        tokenizer: ``encode``/``decode`` object for string prompts and
            text responses (:class:`ByteTokenizer` works for byte-range
            vocabs). Without one, only token-id-array prompts are
            accepted and responses carry ``token_ids`` with empty
            ``text``.
        qos: optional :class:`~paddle_tpu_torch.inference.qos.QosGate`; when
            given, every request is gated per tenant and the grant's
            priority class rides into the engine ladder.
        model_id: the id ``/v1/models`` and responses advertise.
        default_max_tokens: ``max_tokens`` when the request omits it.
        max_tokens_cap: hard ceiling on per-request ``max_tokens``.
        default_timeout: request deadline (seconds) when the request
            carries none (``timeout`` field or ``X-Request-Timeout``
            header). ``None`` = no deadline.
        stream_poll: emit-queue wait quantum; SSE latency is bounded by
            the engine step time, not this.
    """

    def __init__(self, engine=None, cluster=None, tokenizer=None,
                 qos=None, model_id="paddle-tpu-llama",
                 default_max_tokens=64, max_tokens_cap=4096,
                 default_timeout=None, stream_poll=0.005):
        if (engine is None) == (cluster is None):
            raise ValueError(
                "ServingFrontend fronts exactly one backend: pass "
                "engine= OR cluster=")
        self.engine = engine
        self.cluster = cluster
        self.tokenizer = tokenizer
        self.qos = qos
        self.model_id = str(model_id)
        self.default_max_tokens = int(default_max_tokens)
        self.max_tokens_cap = int(max_tokens_cap)
        self.default_timeout = default_timeout
        self.stream_poll = float(stream_poll)
        self._m = _frontend_metrics()
        self._replica = None          # local worker over engine=
        self._svc = None
        self._t0 = time.time()
        # request id -> trace id, bounded: what GET
        # /v1/requests/<id>/trace resolves through
        self._traces = collections.OrderedDict()
        self._traces_cap = 1024
        self._traces_lock = threading.Lock()

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self, port=0, addr="127.0.0.1"):
        """Bind and serve. Returns the running
        :class:`~paddle_tpu_torch.observability.export.HttpService`."""
        if self._svc is not None:
            return self._svc
        if self.engine is not None and self._replica is None:
            from .cluster import EngineReplica

            # the frontend owns a worker thread over the bare engine —
            # admission from a backlog, mixed steps, completion reaping
            # — so HTTP handlers never drive dispatches themselves
            self._replica = EngineReplica(
                "frontend-local", lambda: self.engine).start()
        svc = HttpService(addr=addr, port=port, name="frontend")
        svc.route("/v1/completions", self._completions,
                  methods=("POST",))
        svc.route("/v1/chat/completions", self._chat_completions,
                  methods=("POST",))
        svc.route("/v1/models", self._models)
        svc.route_prefix("/v1/requests/", self._request_trace)
        # /debug/profile: cluster backend -> cluster-wide merged
        # capture; bare engine -> this process only (profile_fn=None
        # falls back to perf.capture_bundle)
        profile_fn = (self.cluster.capture_profile
                      if self.cluster is not None else None)
        add_probe_routes(svc, ready=self._ready,
                         health_info=self._health_info,
                         profile_fn=profile_fn)
        self._svc = svc.start()
        return self._svc

    def stop(self):
        if self._svc is not None:
            self._svc.stop()
            self._svc = None
        if self._replica is not None:
            self._replica.stop_worker()
            self._replica = None

    @property
    def port(self):
        return self._svc.port if self._svc else None

    def _ready(self):
        if self.cluster is not None:
            return self.cluster.ready()
        return self._replica is not None and self._replica.ready()

    def _health_info(self):
        info = {"model": self.model_id,
                "backend": "cluster" if self.cluster is not None
                else "engine"}
        if self.cluster is not None:
            info.update(self.cluster.membership_info())
        return info

    # ------------------------------------------------------------------
    # request parsing
    # ------------------------------------------------------------------
    def _encode_prompt(self, prompt):
        if isinstance(prompt, str):
            if self.tokenizer is None:
                raise ValueError(
                    "string prompts need a tokenizer; this frontend "
                    "has none — send a token-id array instead")
            return self.tokenizer.encode(prompt)
        if isinstance(prompt, (list, tuple)):
            if prompt and all(isinstance(t, int) for t in prompt):
                return [int(t) for t in prompt]
            raise ValueError(
                "prompt must be a string or a non-empty flat array of "
                "token ids (batched prompt arrays are not supported)")
        raise ValueError(f"unsupported prompt type "
                         f"{type(prompt).__name__}")

    def _render_chat(self, messages):
        if not isinstance(messages, list) or not messages:
            raise ValueError("messages must be a non-empty list")
        parts = []
        for m in messages:
            role = m.get("role", "user")
            content = m.get("content", "")
            if not isinstance(content, str):
                raise ValueError("message content must be a string")
            parts.append(f"<|{role}|>\n{content}\n")
        parts.append("<|assistant|>\n")
        return "".join(parts)

    def _stop_ids(self, stop):
        """OpenAI ``stop`` -> engine stop-token ids: ints pass through;
        strings must tokenize to exactly ONE token (the emit-boundary
        check is per token)."""
        if stop is None:
            return ()
        if isinstance(stop, (str, int)):
            stop = [stop]
        out = []
        for s in stop:
            if isinstance(s, int):
                out.append(s)
            elif isinstance(s, str):
                if self.tokenizer is None:
                    raise ValueError(
                        "string stop sequences need a tokenizer")
                ids = self.tokenizer.encode(s)
                if len(ids) != 1:
                    raise ValueError(
                        f"stop sequence {s!r} tokenizes to {len(ids)} "
                        f"tokens; only single-token stops are "
                        f"supported")
                out.append(ids[0])
            else:
                raise ValueError("stop entries must be ints or strings")
        return tuple(out)

    def _sampling_from(self, body):
        bias = body.get("logit_bias") or None
        if bias is not None:
            bias = {int(k): float(v) for k, v in dict(bias).items()}
        return SamplingParams(
            temperature=float(body.get("temperature", 1.0)),
            top_p=float(body.get("top_p", 1.0)),
            top_k=int(body.get("top_k", 0)),
            seed=body.get("seed"),
            logit_bias=bias)

    def _decode(self, ids):
        return self.tokenizer.decode(ids) if self.tokenizer else ""

    # ------------------------------------------------------------------
    # submission + lifecycle against either backend
    # ------------------------------------------------------------------
    def _submit(self, ids, max_tokens, sampling, stop, priority,
                deadline, on_token):
        if self.cluster is not None:
            return self.cluster.submit(
                ids, max_new_tokens=max_tokens, deadline=deadline,
                priority=priority, sampling=sampling, stop=stop,
                on_token=on_token)
        from .cluster import ClusterRequest

        creq = ClusterRequest(
            ids, max_new_tokens=max_tokens, deadline=deadline,
            priority=priority, sampling=sampling, stop=stop,
            on_token=on_token)
        creq._t_submit = time.perf_counter()
        self._replica.submit(creq)
        return creq

    def _cancel(self, creq):
        try:
            if self.cluster is not None:
                self.cluster.cancel(creq)
            else:
                req = creq.cancel()
                if req is not None and self.engine is not None:
                    self.engine.cancel(req)
        except Exception:
            pass            # cancellation is best effort

    def _backend_lost(self):
        """True when the bare-engine deployment's local worker thread
        died: without this check a no-timeout request would poll a
        request that can never finish, forever (the cluster tier has a
        monitor to fail requests over; the local replica does not)."""
        return self._replica is not None and not self._replica.alive()

    # ------------------------------------------------------------------
    # endpoints
    # ------------------------------------------------------------------
    def _models(self, ctx):
        self._m["requests"].labels("models", "200").inc()
        ctx.send_json(200, {"object": "list", "data": [
            {"id": self.model_id, "object": "model",
             "created": int(self._t0), "owned_by": "paddle_tpu"}]})

    def _completions(self, ctx):
        self._handle_generate(ctx, chat=False)

    def _chat_completions(self, ctx):
        self._handle_generate(ctx, chat=True)

    def _handle_generate(self, ctx, chat):
        """Trace-context front door: adopt the caller's W3C
        ``traceparent`` (or mint a fresh root) and activate it for the
        whole handler — every span below (routing, rpc, admission,
        first token, SSE) chains to it, across processes."""
        tctx = _tracing.adopt(ctx.headers.get("traceparent"))
        if tctx is None:        # PADDLE_TPU_METRICS=0: plain dispatch
            return self._generate_impl(ctx, chat, None)
        with _tracing.activate(tctx), \
                _span("frontend.request",
                      endpoint="chat" if chat else "completions"):
            return self._generate_impl(ctx, chat, tctx)

    def _remember_trace(self, rid, trace_id):
        with self._traces_lock:
            self._traces[rid] = trace_id
            while len(self._traces) > self._traces_cap:
                self._traces.popitem(last=False)

    def _request_trace(self, ctx):
        """``GET /v1/requests/<id>/trace`` — one request's merged
        cross-process timeline as a parent-linked span tree."""
        parts = ctx.path.split("/")
        if len(parts) != 5 or parts[4] != "trace":
            self._m["requests"].labels("trace", "404").inc()
            ctx.send_json(404, {"error": {
                "message": f"unknown path {ctx.path!r} (expected "
                           f"/v1/requests/<id>/trace)",
                "type": "invalid_request_error"}})
            return
        rid = parts[3]
        with self._traces_lock:
            trace_id = self._traces.get(rid)
        if trace_id is None:
            self._m["requests"].labels("trace", "404").inc()
            ctx.send_json(404, {"error": {
                "message": f"no trace for request id {rid!r} (evicted, "
                           f"never traced, or tracing disabled)",
                "type": "invalid_request_error"}})
            return
        if self.cluster is not None:
            doc = self.cluster.request_trace(trace_id)
        else:
            from ..observability import trace as _otrace
            doc = {"trace_id": trace_id,
                   "spans": _tracing.span_tree(_otrace.get_events(),
                                               trace_id)}
        doc["request_id"] = rid
        self._m["requests"].labels("trace", "200").inc()
        ctx.send_json(200, doc)

    def _generate_impl(self, ctx, chat, tctx):
        endpoint = "chat" if chat else "completions"
        t_start = time.perf_counter()

        def reply(status, obj, headers=None):
            self._m["requests"].labels(endpoint, str(status)).inc()
            self._m["latency"].labels(endpoint).observe(
                time.perf_counter() - t_start)
            ctx.send_json(status, obj, headers)

        try:
            body = ctx.json()
            if chat:
                ids = self._encode_prompt(
                    self._render_chat(body.get("messages")))
            else:
                ids = self._encode_prompt(body.get("prompt"))
            max_tokens = int(body.get("max_tokens",
                                      self.default_max_tokens))
            if not 1 <= max_tokens <= self.max_tokens_cap:
                raise ValueError(
                    f"max_tokens must be in [1, {self.max_tokens_cap}]"
                    f", got {max_tokens}")
            sampling = self._sampling_from(body)
            stop = self._stop_ids(body.get("stop"))
            stream = bool(body.get("stream", False))
            timeout = body.get("timeout") \
                or ctx.headers.get("X-Request-Timeout") \
                or self.default_timeout
            timeout = None if timeout is None else float(timeout)
            tenant = ctx.headers.get("X-Tenant") \
                or body.get("user") or "default"
        except ValueError as e:
            status, obj = _map_error(e)
            reply(status, obj)
            return

        grant = None
        if self.qos is not None:
            try:
                grant = self.qos.admit(tenant, max_tokens)
            except AdmissionError as e:
                status, obj = _map_error(e)
                reply(status, obj, headers=_retry_headers(e))
                return
        priority = grant.priority if grant is not None \
            else int(body.get("priority", 0))

        emit_q: queue.Queue | None = queue.Queue() if stream else None
        try:
            creq = self._submit(ids, max_tokens, sampling, stop,
                                priority, timeout,
                                on_token=emit_q.put if stream else None)
        except Exception as e:
            # ANY submit failure must settle the grant, or the
            # tenant's inflight slot leaks (AdmissionError and
            # ValueError are the typed cases; a replica rpc timeout is
            # the 502 one)
            if grant is not None:
                self.qos.settle(grant, 0)
            status, obj = _map_error(e)
            reply(status, obj, headers=_retry_headers(e))
            return

        rid = f"{'chatcmpl' if chat else 'cmpl'}-{uuid.uuid4().hex[:24]}"
        if tctx is not None:
            self._remember_trace(rid, tctx.trace_id)
        if stream:
            self._stream_response(ctx, creq, grant, rid, chat,
                                  endpoint, len(ids), timeout, t_start,
                                  emit_q)
        else:
            self._wait_response(reply, creq, grant, rid, chat,
                                len(ids), timeout)

    # ------------------------------------------------------------------
    def _watch(self, creq, timeout, on_first, emit_q=None):
        """Drive one request to terminal: returns (output_ids, err).
        Stamps ``on_first`` at the first observed token. The emit
        queue (fed by the engine's per-token hook) wakes the loop;
        ``partial_output()`` is the source of truth, so subprocess
        replicas (no cross-process hook) stream at poll granularity."""
        t0 = time.perf_counter()
        seen = 0
        while True:
            if creq.done:
                break
            try:
                if emit_q is not None:
                    emit_q.get(timeout=self.stream_poll)
                else:
                    creq.wait(self.stream_poll)
            except queue.Empty:
                pass
            if seen == 0:
                seen = len(creq.partial_output())
                if seen:
                    on_first()
            if self._backend_lost():
                return list(creq.partial_output()), ConnectionError(
                    "serving engine worker died")
            if timeout is not None \
                    and time.perf_counter() - t0 > timeout + 5.0:
                # the deadline should have expired it server-side;
                # +5s of slack then give up client-side too
                self._cancel(creq)
                return list(creq.partial_output()), DeadlineExceeded(
                    f"request not terminal after {timeout}s deadline "
                    f"+ 5s slack")
        return list(creq.output_ids), creq.error

    def _finish_reason(self, creq, n_out, max_tokens):
        if n_out >= max_tokens:
            return "length"
        req = creq.request
        if req is not None and getattr(req, "trimmed", False):
            return "length"         # degradation-ladder trim
        return "stop"               # eos / stop token

    def _usage(self, n_prompt, n_out):
        return {"prompt_tokens": n_prompt, "completion_tokens": n_out,
                "total_tokens": n_prompt + n_out}

    def _wait_response(self, reply, creq, grant, rid, chat, n_prompt,
                       timeout):
        t_submit = time.perf_counter()
        first = {}

        def on_first():
            first["t"] = time.perf_counter() - t_submit
            self._m["ttft"].observe(first["t"])

        out, err = self._watch(creq, timeout, on_first)
        t_done = time.perf_counter()
        n = len(out)
        if grant is not None:
            tpot = None
            if n > 1 and "t" in first:
                tpot = (t_done - t_submit - first["t"]) / (n - 1)
            self.qos.settle(grant, n, ttft=first.get("t"), tpot=tpot)
        if err is not None:
            status, obj = _map_error(err)
            reply(status, obj, headers=_retry_headers(err))
            return
        text = self._decode(out)
        mx = creq.max_new_tokens
        if chat:
            choice = {"index": 0, "message":
                      {"role": "assistant", "content": text},
                      "finish_reason": self._finish_reason(creq, n, mx)}
            obj = {"id": rid, "object": "chat.completion",
                   "created": int(time.time()), "model": self.model_id,
                   "choices": [choice], "usage": self._usage(n_prompt, n)}
        else:
            choice = {"index": 0, "text": text, "token_ids": out,
                      "logprobs": None,
                      "finish_reason": self._finish_reason(creq, n, mx)}
            obj = {"id": rid, "object": "text_completion",
                   "created": int(time.time()), "model": self.model_id,
                   "choices": [choice], "usage": self._usage(n_prompt, n)}
        reply(200, obj)

    # ------------------------------------------------------------------
    def _sse_chunk(self, rid, chat, delta_text, delta_ids,
                   finish_reason, role=None):
        if chat:
            delta = {}
            if role is not None:
                delta["role"] = role
            if delta_text or delta_ids:
                delta["content"] = delta_text
            choice = {"index": 0, "delta": delta,
                      "finish_reason": finish_reason}
            obj = {"id": rid, "object": "chat.completion.chunk",
                   "created": int(time.time()), "model": self.model_id,
                   "choices": [choice]}
        else:
            choice = {"index": 0, "text": delta_text,
                      "token_ids": delta_ids,
                      "finish_reason": finish_reason}
            obj = {"id": rid, "object": "text_completion",
                   "created": int(time.time()), "model": self.model_id,
                   "choices": [choice]}
        return f"data: {json.dumps(obj)}\n\n".encode()

    def _stream_response(self, ctx, creq, grant, rid, chat, endpoint,
                         n_prompt, timeout, t_start, emit_q):
        self._m["streams"].inc()
        w = ctx.stream(200, "text/event-stream")
        t_submit = time.perf_counter()
        sent = 0
        prev_text = ""
        t_first = None
        code = "200"
        try:
            # chat streams open with the role chunk (OpenAI shape)
            if chat:
                w.write(self._sse_chunk(rid, chat, "", [], None,
                                        role="assistant"))
            t0 = time.perf_counter()
            while True:
                done = creq.done
                cur = creq.partial_output()
                if len(cur) < sent:
                    # failover restarted generation behind this stream:
                    # already-sent tokens can't be unsent — fail the
                    # stream honestly instead of splicing sequences
                    raise ConnectionError(
                        "generation restarted behind an active stream "
                        "(replica failover)")
                if len(cur) > sent:
                    if t_first is None:
                        t_first = time.perf_counter() - t_submit
                        self._m["ttft"].observe(t_first)
                    new = cur[sent:]
                    sent = len(cur)
                    full = self._decode(cur)
                    delta, prev_text = full[len(prev_text):], full
                    self._m["stream_tokens"].inc(len(new))
                    w.write(self._sse_chunk(rid, chat, delta, new,
                                            None))
                if not done and self._backend_lost():
                    raise ConnectionError("serving engine worker died")
                if done:
                    err = creq.error
                    if err is not None:
                        status, obj = _map_error(err)
                        code = str(status)
                        w.write(f"data: {json.dumps(obj)}\n\n".encode())
                    else:
                        fr = self._finish_reason(
                            creq, sent, creq.max_new_tokens)
                        final = self._sse_chunk(rid, chat, "", [], fr)
                        w.write(final)
                        w.write(b"data: [DONE]\n\n")
                    break
                if timeout is not None \
                        and time.perf_counter() - t0 > timeout + 5.0:
                    self._cancel(creq)
                    status, obj = _map_error(DeadlineExceeded(
                        f"stream not terminal after {timeout}s + 5s"))
                    code = str(status)
                    w.write(f"data: {json.dumps(obj)}\n\n".encode())
                    break
                try:
                    # the per-request emit queue (fed by the engine's
                    # per-token hook) wakes the loop the moment a step
                    # emits; the poll quantum only bounds subprocess
                    # replicas, whose hook can't cross the process
                    emit_q.get(timeout=self.stream_poll)
                except queue.Empty:
                    pass
        except ClientDisconnected:
            # 499: the client went away — cancel server-side work so
            # KV pages free immediately
            code = "499"
            self._m["disconnects"].inc()
            self._cancel(creq)
        except ConnectionError as e:
            # server-side stream failure (failover restarted
            # generation behind the stream, local worker death): the
            # CLIENT is still connected — tell it, as the error table
            # promises, instead of miscounting a phantom disconnect
            code = "502"
            self._cancel(creq)
            try:
                _, obj = _error_payload(502, str(e), "upstream_error")
                w.write(f"data: {json.dumps(obj)}\n\n".encode())
            except ClientDisconnected:
                pass
        finally:
            n = len(creq.partial_output())
            if grant is not None:
                tpot = None
                if n > 1 and t_first is not None:
                    tpot = (time.perf_counter() - t_submit - t_first) \
                        / (n - 1)
                self.qos.settle(grant, n, ttft=t_first, tpot=tpot)
            self._m["requests"].labels(endpoint, code).inc()
            self._m["latency"].labels(endpoint).observe(
                time.perf_counter() - t_start)


def _retry_headers(err):
    ra = getattr(err, "retry_after", None)
    if ra is None:
        return None
    return {"Retry-After": str(max(1, int(ra + 0.999)))}
