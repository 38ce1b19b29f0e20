"""Exporters: Prometheus text format, JSON snapshots, HTTP serving (a
copy of ``paddle_tpu/observability/export.py``; ``/debug/profile`` goes
through :func:`.perf.capture_bundle`, which this port defers to ROADMAP
A9 and which raises until then: the route answers 500 naming it).

- :func:`json_snapshot` — a pure-data (JSON-serializable) dump of a
  registry; :func:`snapshot_to_prometheus` renders such a snapshot to
  Prometheus text, and :func:`prometheus_text` composes the two — so
  text output round-trips exactly through the JSON snapshot layer
  (serialize, ship, re-render identically on another host).
- :class:`HttpService` — the ONE stdlib ``http.server`` wrapper every
  in-process endpoint builds on (the metrics scrape port, the replica
  worker's health port, the cluster's tier endpoint, and the
  OpenAI-compatible serving frontend): a route table over a threaded
  daemon server, request context helpers (JSON bodies/replies, SSE
  streaming with typed client-disconnect), ``.port`` / ``.url`` /
  ``.stop``.
- :func:`add_probe_routes` — installs the standard observability
  routes (``/metrics`` text + HEAD, ``/metrics.json`` snapshot,
  ``/healthz`` liveness with ``health_info`` merge, ``/readyz``
  readiness that turns 503 while the local engine drains) on any
  :class:`HttpService`.
- :func:`start_http_server` — the classic scrape endpoint: an
  :class:`HttpService` with just the probe routes.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time

from .metrics import default_registry

__all__ = ["json_snapshot", "snapshot_to_prometheus", "prometheus_text",
           "start_http_server", "ScrapeServer", "HttpService",
           "HttpContext", "ClientDisconnected", "add_probe_routes",
           "merge_snapshots", "aggregate_snapshot"]


def _fmt_value(v):
    if isinstance(v, str):
        return v    # non-finite marker straight from a JSON snapshot
    v = float(v)
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _json_value(v):
    """Float for the snapshot, except non-finite values become their
    Prometheus markers ("+Inf"/"-Inf"/"NaN"): json.dumps would emit bare
    Infinity/NaN — invalid JSON that strict parsers (JSON.parse, jq, Go)
    reject, breaking the documented cross-host snapshot round-trip."""
    v = float(v)
    if not math.isfinite(v):
        return _fmt_value(v)
    return v


def _escape(v):
    return str(v).replace("\\", r"\\").replace('"', r'\"') \
        .replace("\n", r"\n")


def _label_str(labelnames, values, extra=()):
    pairs = list(zip(labelnames, values)) + list(extra)
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"' for k, v in pairs) + "}"


def json_snapshot(registry=None):
    """List of metric dicts (name/help/type/labelnames/samples) holding
    only JSON-native values — ``json.dumps`` round-trips it losslessly."""
    reg = registry if registry is not None else default_registry()
    out = []
    for m in reg.collect():
        entry = {"name": m.name, "help": m.help, "type": m.kind,
                 "labelnames": list(m.labelnames), "samples": []}
        for values, leaf in m.samples():
            sample = {"labels": list(values)}
            if m.kind == "histogram":
                counts, total = leaf.snapshot()
                sample.update(buckets=list(leaf.buckets),
                              counts=counts,
                              sum=_json_value(total),
                              count=int(sum(counts)))
            else:
                sample["value"] = _json_value(leaf.value)
            entry["samples"].append(sample)
        out.append(entry)
    return out


def snapshot_to_prometheus(snapshot):
    """Render a :func:`json_snapshot` (or its JSON round-trip) to
    Prometheus exposition text (version 0.0.4)."""
    lines = []
    for entry in snapshot:
        name, kind = entry["name"], entry["type"]
        labelnames = entry.get("labelnames", [])
        if entry.get("help"):
            lines.append(f"# HELP {name} {_escape(entry['help'])}")
        lines.append(f"# TYPE {name} {kind}")
        for sample in entry["samples"]:
            values = sample.get("labels", [])
            if kind == "histogram":
                acc = 0
                bounds = list(sample["buckets"]) + ["+Inf"]
                for bound, c in zip(bounds, sample["counts"]):
                    acc += c
                    le = "+Inf" if bound == "+Inf" else _fmt_value(bound)
                    ls = _label_str(labelnames, values, [("le", le)])
                    lines.append(f"{name}_bucket{ls} {acc}")
                ls = _label_str(labelnames, values)
                lines.append(f"{name}_sum{ls} {_fmt_value(sample['sum'])}")
                lines.append(f"{name}_count{ls} {sample['count']}")
            else:
                ls = _label_str(labelnames, values)
                lines.append(f"{name}{ls} {_fmt_value(sample['value'])}")
    return "\n".join(lines) + "\n" if lines else ""


def prometheus_text(registry=None):
    """Prometheus text for a registry (the scrape-endpoint body)."""
    return snapshot_to_prometheus(json_snapshot(registry))


def merge_snapshots(sources, label="replica"):
    """Merge per-process :func:`json_snapshot` lists into ONE snapshot
    with ``label`` prepended to every metric's labelnames — the
    one-pane cluster view: ``sources`` is an iterable of ``(label_value,
    snapshot)`` pairs and every sample keeps its original labels behind
    the new ``label`` value. A source whose entry disagrees with the
    first-seen schema for a name (different type or labelnames — a
    version-skewed replica) is skipped for that metric rather than
    corrupting the pane."""
    merged, order = {}, []
    for src_value, snapshot in sources:
        for entry in snapshot or ():
            name = entry["name"]
            names = list(entry.get("labelnames", []))
            cur = merged.get(name)
            if cur is None:
                cur = {"name": name, "help": entry.get("help", ""),
                       "type": entry["type"],
                       "labelnames": [label] + names, "samples": []}
                merged[name] = cur
                order.append(name)
            elif (cur["type"] != entry["type"]
                  or cur["labelnames"][1:] != names):
                continue
            for sample in entry.get("samples", ()):
                s = dict(sample)
                s["labels"] = ([str(src_value)]
                               + list(sample.get("labels", [])))
                cur["samples"].append(s)
    return [merged[n] for n in order]


def _add_json(a, b):
    # float() accepts the "+Inf"/"-Inf"/"NaN" snapshot markers
    return _json_value(float(a) + float(b))


def aggregate_snapshot(snapshot, drop_label="replica"):
    """Collapse ``drop_label`` out of a merged snapshot: samples that
    agree on every remaining label combine exactly — counters/gauges
    sum, histograms merge element-wise (a sample whose bucket bounds
    disagree with the first-seen bounds is skipped). Entries without
    ``drop_label`` pass through unchanged. The inverse of
    :func:`merge_snapshots` up to summation — what the SLO engine and
    tier-level dashboards consume."""
    out = []
    for entry in snapshot:
        labelnames = list(entry.get("labelnames", []))
        if drop_label not in labelnames:
            out.append(entry)
            continue
        i = labelnames.index(drop_label)
        agg, order = {}, []
        for sample in entry.get("samples", ()):
            labels = list(sample.get("labels", []))
            key = tuple(labels[:i] + labels[i + 1:])
            cur = agg.get(key)
            if entry["type"] == "histogram":
                if cur is None:
                    agg[key] = {"labels": list(key),
                                "buckets": list(sample["buckets"]),
                                "counts": list(sample["counts"]),
                                "sum": sample["sum"],
                                "count": int(sample["count"])}
                    order.append(key)
                elif list(sample["buckets"]) == cur["buckets"]:
                    cur["counts"] = [a + b for a, b in
                                     zip(cur["counts"], sample["counts"])]
                    cur["sum"] = _add_json(cur["sum"], sample["sum"])
                    cur["count"] += int(sample["count"])
            else:
                if cur is None:
                    agg[key] = {"labels": list(key),
                                "value": sample["value"]}
                    order.append(key)
                else:
                    cur["value"] = _add_json(cur["value"],
                                             sample["value"])
        out.append({"name": entry["name"], "help": entry.get("help", ""),
                    "type": entry["type"],
                    "labelnames": (labelnames[:i]
                                   + labelnames[i + 1:]),
                    "samples": [agg[k] for k in order]})
    return out


class ClientDisconnected(ConnectionError):
    """The HTTP client went away mid-response (broken pipe / reset) —
    the typed signal a streaming handler uses to cancel server-side
    work (the frontend maps it to a 499 tally + ``engine.cancel``)."""


class HttpContext:
    """Per-request view handed to :class:`HttpService` route handlers:
    request line/headers/body access plus reply helpers. A handler
    either calls ``send``/``send_json`` once, or ``stream(...)`` and
    writes chunks; returning without replying is a 500."""

    def __init__(self, handler, head_only=False):
        self._h = handler
        self._head_only = head_only
        self.method = "HEAD" if head_only else handler.command
        self.path = handler.path.split("?", 1)[0]
        self.query = handler.path.partition("?")[2]
        self.headers = handler.headers
        self.replied = False

    def body(self):
        n = int(self.headers.get("Content-Length") or 0)
        return self._h.rfile.read(n) if n else b""

    def json(self):
        """Parsed JSON body; raises ValueError on malformed input (the
        service maps it to a 400)."""
        raw = self.body()
        if not raw:
            raise ValueError("empty request body (expected JSON)")
        try:
            return json.loads(raw.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"malformed JSON body: {e}") from None

    def send(self, status, body, ctype="application/json",
             headers=None):
        self.replied = True
        h = self._h
        h.send_response(int(status))
        h.send_header("Content-Type", ctype)
        h.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            h.send_header(k, str(v))
        h.end_headers()
        if not self._head_only:
            h.wfile.write(body)

    def send_json(self, status, obj, headers=None):
        self.send(status, json.dumps(obj).encode(), "application/json",
                  headers)

    def stream(self, status=200, ctype="text/event-stream",
               headers=None):
        """Open an unframed streaming response (Connection: close
        delimits the body — SSE-friendly and proxy-simple). Returns a
        writer with ``.write(bytes)`` / ``.flush()``; a vanished client
        surfaces as :class:`ClientDisconnected` from the next write."""
        self.replied = True
        h = self._h
        h.send_response(int(status))
        h.send_header("Content-Type", ctype)
        h.send_header("Cache-Control", "no-cache")
        h.send_header("Connection", "close")
        for k, v in (headers or {}).items():
            h.send_header(k, str(v))
        h.end_headers()
        ctx = self

        class _Writer:
            def write(self, data):
                if ctx._head_only:
                    return
                try:
                    h.wfile.write(data)
                    h.wfile.flush()
                except (BrokenPipeError, ConnectionResetError,
                        OSError) as e:
                    raise ClientDisconnected(str(e)) from e

        return _Writer()


class HttpService:
    """Threaded stdlib HTTP server behind a route table — the shared
    implementation under the metrics scrape endpoint, the replica
    worker's health port, the cluster tier endpoint and the serving
    frontend (each used to re-wrap ``http.server`` ad hoc).

    ``route(path, handler, methods)`` registers ``handler(ctx)`` for
    exact-path matches; HEAD auto-maps to the GET handler with the
    body suppressed (Content-Length still reflects the full render).
    Handlers that raise reply 500 (ValueError: 400); unknown paths
    404. ``start()`` binds and serves on a daemon thread; ``stop()``
    shuts down and joins."""

    def __init__(self, addr="127.0.0.1", port=0, name="http"):
        self._addr = addr
        self._want_port = port
        self.name = name
        self._routes = {}
        self._prefix_routes = []
        self._httpd = None
        self._thread = None
        self.port = None
        self.url = None

    def route(self, path, handler, methods=("GET",)):
        for m in methods:
            self._routes[(m, path)] = handler
        return self

    def route_prefix(self, prefix, handler, methods=("GET",)):
        """Register ``handler(ctx)`` for any path starting with
        ``prefix`` (path-parameter routes like ``/v1/requests/<id>/
        trace``). Exact routes win; among prefixes the longest match
        wins. The handler reads the remainder off ``ctx.path``."""
        for m in methods:
            self._prefix_routes.append((m, str(prefix), handler))
        self._prefix_routes.sort(key=lambda r: -len(r[1]))
        return self

    def _match_prefix(self, method, path, head_only=False):
        for m, prefix, fn in self._prefix_routes:
            if path.startswith(prefix) and (
                    m == method or (head_only and m == "GET")):
                return fn
        return None

    def start(self):
        from http.server import (BaseHTTPRequestHandler,
                                 ThreadingHTTPServer)

        if self._httpd is not None:
            return self
        svc = self

        class Handler(BaseHTTPRequestHandler):
            def _dispatch(self, head_only=False):
                ctx = HttpContext(self, head_only=head_only)
                fn = svc._routes.get((ctx.method, ctx.path))
                if fn is None and head_only:
                    fn = svc._routes.get(("GET", ctx.path))
                if fn is None:
                    fn = svc._match_prefix(ctx.method, ctx.path,
                                           head_only)
                if fn is None:
                    self.send_error(404)
                    return
                try:
                    fn(ctx)
                    if not ctx.replied:
                        ctx.send_json(500, {"error": {
                            "message": "handler produced no response",
                            "type": "server_error"}})
                except ClientDisconnected:
                    pass        # the handler already cleaned up
                except ValueError as e:
                    if not ctx.replied:
                        ctx.send_json(400, {"error": {
                            "message": str(e),
                            "type": "invalid_request_error"}})
                except (BrokenPipeError, ConnectionResetError):
                    pass        # client gone mid-plain-reply
                except Exception as e:
                    if not ctx.replied:
                        ctx.send_json(500, {"error": {
                            "message": f"{type(e).__name__}: {e}",
                            "type": "server_error"}})

            def do_GET(self):
                self._dispatch()

            def do_POST(self):
                self._dispatch()

            def do_HEAD(self):
                # probes use HEAD to skip the body; the full text is
                # still rendered so Content-Length matches a GET
                self._dispatch(head_only=True)

            def log_message(self, *args):   # no stderr spam per scrape
                pass

        self._httpd = ThreadingHTTPServer((self._addr, self._want_port),
                                          Handler)
        self.port = self._httpd.server_address[1]
        self.url = f"http://{self._addr}:{self.port}/metrics"
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"{self.name}-server")
        self._thread.start()
        return self

    def stop(self):
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._httpd = None
        self._thread = None


#: Back-compat alias: callers that type-checked the old handle class
#: keep working — the service IS the handle now.
ScrapeServer = HttpService


def add_probe_routes(svc, registry=None, ready=None, health_info=None,
                     snapshot_fn=None, profile_fn=None):
    """Install the standard probe routes on an :class:`HttpService`:
    ``/metrics`` (+ ``/``), ``/metrics.json``, ``/healthz``,
    ``/readyz``.

    ``ready`` is an optional zero-arg callable consulted per
    ``/readyz`` probe: truthy -> 200, falsy (or raising) -> 503 — 503
    means "alive but do not send traffic", the state a draining or
    admission-paused serving replica is in, so load balancers stop
    routing BEFORE ``drain()`` finishes. ``/healthz`` stays 200 the
    whole time (the process is healthy; restarting it would be wrong).
    With ``ready=None``, ``/readyz`` mirrors ``/healthz``.

    ``health_info`` is an optional zero-arg callable whose dict is
    merged into the ``/healthz`` document per probe (e.g. membership
    epoch + last-heartbeat age, so an operator can spot a fenced-out
    stale incarnation from the probe alone); a raising callable
    degrades to the base document rather than failing liveness.

    ``snapshot_fn`` overrides what ``/metrics`` + ``/metrics.json``
    render: a zero-arg callable returning a :func:`json_snapshot`-shaped
    list (e.g. ``ServingCluster.scrape`` — the merged one-pane cluster
    snapshot) instead of the local registry.

    ``profile_fn`` backs ``/debug/profile?seconds=N``: a callable taking
    the window in seconds and returning a Perfetto-loadable trace dict
    (e.g. ``ServingCluster.capture_profile`` for a cluster-wide merged
    capture). With ``profile_fn=None`` the route captures THIS process
    via :func:`~.perf.capture_bundle`. Returns 503 when capture is
    disabled (``PADDLE_TPU_METRICS=0``)."""
    from . import perf as _perf

    reg = registry if registry is not None else default_registry()
    t_start = time.monotonic()

    def _snapshot():
        _perf.ensure_build_info(reg)
        if snapshot_fn is not None:
            return snapshot_fn()
        return json_snapshot(reg)

    def metrics(ctx):
        ctx.send(200, snapshot_to_prometheus(_snapshot()).encode(),
                 "text/plain; version=0.0.4; charset=utf-8")

    def metrics_json(ctx):
        ctx.send_json(200, _snapshot())

    def healthz(ctx):
        doc = {"status": "ok", "pid": os.getpid(),
               "uptime_seconds": round(time.monotonic() - t_start, 3)}
        if health_info is not None:
            try:
                doc.update(health_info() or {})
            except Exception:
                pass    # liveness must not fail on extras
        ctx.send_json(200, doc)

    def readyz(ctx):
        ok = True
        if ready is not None:
            try:
                ok = bool(ready())
            except Exception:
                ok = False
        ctx.send_json(200 if ok else 503,
                      {"status": "ready" if ok else "not_ready",
                       "pid": os.getpid()})

    def debug_profile(ctx):
        import urllib.parse

        try:
            q = urllib.parse.parse_qs(ctx.query)
            seconds = float(q.get("seconds", ["1.0"])[0])
        except (ValueError, TypeError):
            ctx.send_json(400, {"error": "bad seconds parameter"})
            return
        seconds = min(max(seconds, 0.0), 30.0)    # bound the window
        try:
            if profile_fn is not None:
                bundle = profile_fn(seconds)
            else:
                bundle = _perf.capture_bundle(seconds)
        except Exception as e:
            ctx.send_json(500, {"error": f"capture failed: {e!r}"})
            return
        if bundle is None:
            ctx.send_json(503, {"error": "profiling disabled "
                                         "(PADDLE_TPU_METRICS=0)"})
            return
        ctx.send_json(200, bundle)

    svc.route("/", metrics)
    svc.route("/metrics", metrics)
    svc.route("/metrics.json", metrics_json)
    svc.route("/healthz", healthz)
    svc.route("/readyz", readyz)
    svc.route("/debug/profile", debug_profile)
    return svc


def start_http_server(port=0, addr="127.0.0.1", registry=None,
                      ready=None, health_info=None, snapshot_fn=None,
                      profile_fn=None):
    """Serve the probe routes (see :func:`add_probe_routes`) on a
    daemon thread; ``port=0`` picks a free port. Returns the running
    :class:`HttpService` (``.port`` / ``.url`` / ``.stop``)."""
    svc = HttpService(addr=addr, port=port, name="metrics")
    add_probe_routes(svc, registry=registry, ready=ready,
                     health_info=health_info, snapshot_fn=snapshot_fn,
                     profile_fn=profile_fn)
    return svc.start()
