"""The port's OpenAI-compatible front door against the reference's
(``tests/test_frontend.py``): ``/v1/completions``,
``/v1/chat/completions``, SSE streaming, ``/v1/models``, the probes, the
typed-error -> HTTP map (400, 429 with ``Retry-After``, 504, 502, 499,
500) and the QoS gate. One scripted exchange runs against each package's
frontend, over a bare engine and over a two-replica cluster, on the same
fitted tiny model: the status codes, the ``Retry-After`` headers and the
bodies (ids, timestamps and timings masked) are equal across packages,
and the greedy tokens equal the reference engine's ``fused_kv=False``
path.
"""

import json
import os
import re
import socket
import time
import urllib.error
import urllib.request

import pytest

import torch_stack_common as common

from paddle_tpu.inference import cluster as jax_cluster
from paddle_tpu.inference import frontend as jax_frontend
from paddle_tpu.inference import qos as jax_qos
from paddle_tpu.inference import serving as jax_serving

from paddle_tpu_torch.inference import cluster, frontend, qos, serving

common.one_thread()

MODS = {"reference": (jax_frontend, jax_qos, jax_serving, jax_cluster),
        "port": (frontend, qos, serving, cluster)}


class FrozenClock:
    def __call__(self):
        return 1000.0


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    arrays = common.fitted_arrays(tmp_path_factory)
    jm = common.reference_model(arrays)
    prompts = [[5, 6, 7, 8, 9, 10, 11], list(b"The quick "),
               list(b"<|user|>\nhi\n<|assistant|>\n")]
    return {"reference": jm, "port": common.port_model(arrays),
            "prompts": prompts, "oracle": common.oracle(jm, prompts)}


class Door:
    """One package's frontend over a bare engine or a cluster, with a
    QoS gate whose clock stands still (so ``retry_after`` is exact)."""

    def __init__(self, name, model, backend, tmp_path):
        fe_mod, qos_mod, sv, cl = MODS[name]
        self.name, self.fe_mod = name, fe_mod
        geom = dict(common.GEOM, max_batch=4, num_pages=64,
                    prefix_cache=False)
        if name == "reference":
            geom["fused_kv"] = False
        self.gate = qos_mod.QosGate([
            qos_mod.Tenant("prem", tier="premium"),
            qos_mod.Tenant("flood", tier="batch", rate=10, burst=10)],
            clock=FrozenClock())
        self.cluster = self.engine = None
        tok = fe_mod.ByteTokenizer(vocab_size=model.config.vocab_size)
        if backend == "engine":
            self.engine = sv.LlamaServingEngine(model, **geom)
            self.fe = fe_mod.ServingFrontend(engine=self.engine,
                                             qos=self.gate, tokenizer=tok)
        else:
            self.cluster = cl.ServingCluster(
                lambda: sv.LlamaServingEngine(model, **geom),
                num_replicas=2, store_path=str(tmp_path / name),
                ttl=10.0).start()
            self.fe = fe_mod.ServingFrontend(cluster=self.cluster,
                                             qos=self.gate, tokenizer=tok)
        self.fe.start(port=0)
        self.base = f"http://127.0.0.1:{self.fe.port}"

    def close(self):
        self.fe.stop()
        if self.cluster is not None:
            self.cluster.stop()

    def call(self, path, body=None, headers=None):
        """(status, Retry-After, parsed body) of one request."""
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(
            self.base + path, data=data,
            headers={"Content-Type": "application/json", **(headers or {})})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, r.headers.get("Retry-After"), \
                    json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, e.headers.get("Retry-After"), json.loads(e.read())


_NUM = re.compile(r"\d+\.\d+(e-?\d+)?")


def _mask(doc):
    """Ids, timestamps and measured times out of a response body."""
    if isinstance(doc, dict):
        return {k: ("<masked>" if k in ("id", "created", "pid")
                    else _mask(v)) for k, v in doc.items()}
    if isinstance(doc, list):
        return [_mask(v) for v in doc]
    if isinstance(doc, str):
        return _NUM.sub("<num>", doc)
    return doc


def _script(door, prompts, oracle):
    """The scripted exchange; returns [(status, Retry-After, body)]."""
    door.gate.settle(door.gate.admit("flood"), completed_tokens=100)
    out = []
    for path, body, headers in [
        ("/v1/models", None, None),
        ("/v1/completions", {"prompt": prompts[0], "max_tokens": common.NEW,
                             "temperature": 0}, None),
        ("/v1/completions", {"prompt": "The quick ", "max_tokens": common.NEW,
                             "temperature": 0}, {"X-Tenant": "prem"}),
        ("/v1/chat/completions",
         {"messages": [{"role": "user", "content": "hi"}],
          "max_tokens": common.NEW, "temperature": 0}, None),
        ("/v1/completions", {"prompt": prompts[0], "max_tokens": common.NEW,
                             "temperature": 0,
                             "stop": [oracle[0][2]]}, None),
        ("/v1/completions", {"prompt": 12}, None),
        ("/v1/completions", {"prompt": [1, 2], "max_tokens": 0}, None),
        ("/v1/completions", {"prompt": [1, 2], "stop": "ab"}, None),
        ("/v1/chat/completions", {"messages": []}, None),
        ("/v1/completions", {"prompt": [1, 2], "max_tokens": 2},
         {"X-Tenant": "flood"}),
        ("/v1/completions", {"prompt": [1, 2], "max_tokens": 4,
                             "timeout": 1e-9}, None),
        ("/v1/requests/cmpl-nope/trace", None, None),
        ("/readyz", None, None),
    ]:
        out.append(door.call(path, body, headers))
    return out


@pytest.mark.parametrize("backend", ["engine", "cluster"])
def test_scripted_exchange_matches_reference(fitted, backend, tmp_path):
    got = {}
    for name in ("reference", "port"):
        door = Door(name, fitted[name], backend, tmp_path)
        try:
            got[name] = _script(door, fitted["prompts"], fitted["oracle"])
        finally:
            door.close()
    ref, port = got["reference"], got["port"]
    assert [r[:2] for r in port] == [r[:2] for r in ref]
    assert [_mask(r[2]) for r in port] == [_mask(r[2]) for r in ref]
    codes = [r[0] for r in port]
    assert codes == [200, 200, 200, 200, 200, 400, 400, 400, 400, 429, 504,
                     404, 200]
    assert port[9][1] == "10"           # (100 - 10 + 1) / 10 rounded up
    assert port[1][2]["choices"][0]["token_ids"] == fitted["oracle"][0]
    assert port[2][2]["choices"][0]["token_ids"] == fitted["oracle"][1]
    assert port[3][2]["choices"][0]["message"]["content"] \
        == bytes(fitted["oracle"][2]).decode("utf-8", errors="replace")
    # a stop token ends the output before it
    assert port[4][2]["choices"][0]["token_ids"] \
        == fitted["oracle"][0][:fitted["oracle"][0].index(
            fitted["oracle"][0][2])]
    assert port[4][2]["choices"][0]["finish_reason"] == "stop"
    assert port[1][2]["usage"] == {"prompt_tokens": 7,
                                   "completion_tokens": common.NEW,
                                   "total_tokens": 7 + common.NEW}


# ---------------------------------------------------------------------
# SSE, the client-disconnect 499, 502 and 500, per package
# ---------------------------------------------------------------------
@pytest.fixture(params=["reference", "port"])
def door(request, fitted, tmp_path):
    d = Door(request.param, fitted[request.param], "engine", tmp_path)
    yield d
    d.close()


def _open_stream(port, path, body):
    payload = json.dumps(body).encode()
    sock = socket.create_connection(("127.0.0.1", port), timeout=60)
    sock.sendall(
        f"POST {path} HTTP/1.1\r\nHost: x\r\n"
        f"Content-Type: application/json\r\n"
        f"Content-Length: {len(payload)}\r\n\r\n".encode() + payload)
    rf = sock.makefile("rb")
    status = int(rf.readline().split()[1])
    while rf.readline().strip():
        pass
    return sock, rf, status


def _stream_events(door, body, path="/v1/completions"):
    sock, rf, status = _open_stream(door.fe.port, path, body)
    try:
        assert status == 200
        events = []
        for line in rf:
            line = line.strip()
            if not line.startswith(b"data: "):
                continue
            if line == b"data: [DONE]":
                events.append("[DONE]")
                break
            events.append(json.loads(line[len(b"data: "):]))
        return events
    finally:
        sock.close()


def test_sse_chunks_are_the_tokens(door, fitted):
    events = _stream_events(door, {"prompt": fitted["prompts"][0],
                                   "max_tokens": common.NEW,
                                   "temperature": 0, "stream": True})
    assert events[-1] == "[DONE]"
    chunks = events[:-1]
    toks = [t for c in chunks for t in c["choices"][0]["token_ids"]]
    assert toks == fitted["oracle"][0]
    assert chunks[-1]["choices"][0]["finish_reason"] == "length"
    assert {c["object"] for c in chunks} == {"text_completion"}
    chat = _stream_events(door, {"messages": [{"role": "user",
                                               "content": "ok"}],
                                 "max_tokens": 3, "stream": True},
                          "/v1/chat/completions")
    assert chat[-1] == "[DONE]"
    assert chat[0]["choices"][0]["delta"].get("role") == "assistant"
    assert chat[0]["object"] == "chat.completion.chunk"


def test_client_disconnect_is_499_and_restores_pages(door):
    engine = door.engine
    free0 = engine.alloc.free_pages
    m = door.fe._m
    base = m["disconnects"]._value
    code0 = m["requests"].labels("completions", "499")._value
    sock, rf, status = _open_stream(door.fe.port, "/v1/completions",
                                    {"prompt": [4, 5, 6], "max_tokens": 300,
                                     "stream": True})
    assert status == 200
    while not rf.readline().strip().startswith(b"data: "):
        pass
    sock.shutdown(socket.SHUT_RDWR)
    rf.close()
    sock.close()
    deadline = time.time() + 30
    while time.time() < deadline:
        if not engine._live and engine.alloc.free_pages == free0 \
                and m["disconnects"]._value == base + 1:
            break
        time.sleep(0.05)
    assert not engine._live and engine.alloc.free_pages == free0
    assert m["disconnects"]._value == base + 1
    assert m["requests"].labels("completions", "499")._value == code0 + 1


@pytest.mark.parametrize("exc, code, etype", [
    (ConnectionError("replica unreachable"), 502, "upstream_error"),
    (RuntimeError("rpc lost"), 500, "server_error")])
def test_submit_failures_map_and_settle_the_grant(door, monkeypatch, exc,
                                                  code, etype):
    def explode(*a, **kw):
        raise exc
    monkeypatch.setattr(door.fe, "_submit", explode)
    status, _, body = door.call("/v1/completions",
                                {"prompt": [1, 2], "max_tokens": 2},
                                {"X-Tenant": "prem"})
    assert (status, body["error"]["type"], body["error"]["code"]) \
        == (code, etype, code)
    assert door.gate.snapshot()["prem"]["inflight"] == 0


def test_debug_profile_serves_a_local_bundle(door):
    status, _, bundle = door.call("/debug/profile?seconds=0.1")
    assert status == 200 and "traceEvents" in bundle
    assert bundle["capture"]["profiler"][0]["ok"] is True
    os.environ["PADDLE_TPU_METRICS"] = "0"
    try:
        status, _, _ = door.call("/debug/profile?seconds=0.1")
    finally:
        os.environ.pop("PADDLE_TPU_METRICS")
    assert status == 503
