"""The HTTP surface of the port's server (``subgc_tpu_torch/cli/serve.py``)
on the CPU: the cases of ``tests/test_serve.py`` that need no mesh, over
real HTTP on 127.0.0.1, as cases of parametrised tests, with the JAX
server's status codes.  GET ``/healthz``, ``/models``, ``/stats`` and 404
elsewhere; POST ``/caption`` and ``/caption_stream`` (NDJSON and its
``{"done": ...}`` trailer, the first chunk decoded before the 200); 400 on
a request the server cannot read, 429 + ``Retry-After`` when the queue is
full, 500 when the backend fails; per-request dtype and model routing;
the warmup; least-loaded routing; replicas over two CPU devices; and
``load_registry`` from a checkpoint the JAX package wrote.  Every HTTP
call has a timeout and every server shuts down in a ``finally``.
"""
import argparse
import json
import threading
import time
import urllib.error
import urllib.request
from contextlib import contextmanager

import numpy as np
import pytest

from subgc_tpu.config import config_to_json as j_config_to_json
from subgc_tpu.config import ModelConfig as JModelConfig
from subgc_tpu.train import checkpoint as JC
from subgc_tpu_torch.cli import serve as PS
from subgc_tpu_torch.config import EvalConfig, ModelConfig

from .test_torch_port_serve import (EVAL, VOCAB, WIDTHS, image,  # noqa
                                    pinned_flags, weights)
from .test_torch_port_train import one_thread  # noqa: F401

TIMEOUT = 120


@contextmanager
def running(service):
    """``serve(service)`` on a free port in a thread; shut down after."""
    httpd = PS.serve(service, port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=30)


def call(url, payload=None, raw=None):
    """(status, headers, body bytes) of a GET (no payload) or a POST."""
    data = raw if raw is not None else (
        None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(url, data,
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            return resp.getcode(), resp.headers, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


@contextmanager
def flags_restored():
    """The process-global matmul flags a service pins, restored after (a
    module-scoped fixture has no monkeypatch)."""
    import torch
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (m.allow_bf16_reduced_precision_reduction, m.allow_tf32,
             c.allow_tf32)
    try:
        yield
    finally:
        (m.allow_bf16_reduced_precision_reduction, m.allow_tf32,
         c.allow_tf32) = saved


@pytest.fixture(scope="module")
def plain():
    """A plain build_service handle (one fixed model and dtype)."""
    params, state = weights()
    with flags_restored():
        handle = PS.build_service(params, state, ModelConfig(**WIDTHS),
                                  EvalConfig(**EVAL), VOCAB, batch_images=2,
                                  microbatch_wait_ms=20.0, device="cpu")
        with running(handle) as url:
            yield url, handle


@pytest.fixture(scope="module")
def registry():
    """Two models behind one endpoint, float32 by default."""
    with flags_restored():
        reg = PS.ModelRegistry()
        for name, seed, tag in (("kar", 0, "k"), ("mrnn", 1, "m")):
            params, state = weights(seed)
            reg.add(name, PS.ModelService(
                params, state, ModelConfig(**WIDTHS), EvalConfig(**EVAL),
                {str(i): f"{tag}{i}" for i in range(1, 31)},
                default_dtype="float32", batch_images=2,
                microbatch_wait_ms=5.0, device="cpu"))
        with running(reg) as url:
            yield url, reg


def test_parse_checkpoint_spec(tmp_path):
    assert PS.parse_checkpoint_spec("kar=/ckpts/run1") == \
        ("kar", "/ckpts/run1")
    assert PS.parse_checkpoint_spec("/ckpts/run1/") == \
        ("run1", "/ckpts/run1/")
    assert PS.parse_checkpoint_spec("m=/ckpts/lr=5e-4/run") == \
        ("m", "/ckpts/lr=5e-4/run")
    d = tmp_path / "lr=5e-4"
    d.mkdir()
    assert PS.parse_checkpoint_spec(str(d)) == ("lr=5e-4", str(d))


@pytest.mark.parametrize("server,path,code", [
    ("plain", "/healthz", 200), ("plain", "/nope", 404),
    ("plain", "/models", 404), ("registry", "/healthz", 200),
    ("registry", "/models", 200), ("registry", "/stats", 200),
    ("registry", "/caption", 404)])
def test_get_endpoints(server, path, code, request):
    url, svc = request.getfixturevalue(server)
    status, _, body = call(url + path)
    assert status == code
    body = json.loads(body)
    if path == "/healthz":
        assert body == {"ok": True}
    elif code == 200 and path == "/models":
        assert body["default"] == "kar"
        assert set(body["models"]) == {"kar", "mrnn"}
        kar = body["models"]["kar"]
        assert kar["default_dtype"] == "float32"
        assert (kar["replicas"], kar["fanout_devices"]) == (1, 1)
    elif code == 200:
        assert set(body) == {"kar", "mrnn"}
    else:
        assert body == {"error": "not found"}


def _img(i=0, seed=17, **kw):
    return image(np.random.RandomState(seed + i), i, **kw)


@pytest.mark.parametrize("server,endpoint,payload", [
    ("plain", "/caption", {}),
    ("plain", "/caption", {"images": 42}),
    ("plain", "/caption", "not json"),
    ("plain", "/caption", {"images": [{"object_fmap": [[0.0] * 64]}]}),
    ("plain", "/caption", {"images": [_img()], "dtype": "bfloat16"}),
    ("plain", "/caption_stream", {"images": [_img()], "model": "kar"}),
    ("plain", "/caption_stream", {"wrong": 1}),
    ("plain", "/caption_stream", {"images": [_img()], "chunk": "four"}),
    ("plain", "/caption_stream", {"images": [_img()], "chunk": 0}),
    ("registry", "/caption", {"images": [_img()], "dtype": "float16"}),
    ("registry", "/caption", {"images": [_img()], "model": "nope"}),
    ("registry", "/caption_stream", {"images": [_img()], "model": "nope"}),
    ("registry", "/caption_stream", {"images": [_img()], "dtype": "fp8"})])
def test_bad_requests_are_400(server, endpoint, payload, request):
    url, _ = request.getfixturevalue(server)
    raw = payload.encode() if isinstance(payload, str) else None
    status, _, body = call(url + endpoint, payload, raw=raw)
    assert status == 400, body
    assert "error" in json.loads(body)


def test_caption_request_and_ignored_chunk(plain):
    url, _ = plain
    imgs = [_img(7, with_subgraphs=True), _img(8, with_subgraphs=False)]
    status, _, body = call(url + "/caption", {"images": imgs})
    assert status == 200
    results = json.loads(body)["results"]
    assert [r["id"] for r in results] == [7, 8]
    for r in results:
        assert 1 <= len(r["captions"]) == len(r["scores"])
        assert all(isinstance(c, str) for c in r["captions"])
        assert all(a >= b for a, b in zip(r["scores"], r["scores"][1:]))
    for chunk in ("four", 2.5, 3):          # /caption ignores chunk
        status, _, again = call(url + "/caption",
                                {"images": imgs, "chunk": chunk})
        assert status == 200 and json.loads(again)["results"] == results


@pytest.mark.parametrize("chunk", [2, 8])
def test_caption_stream(chunk, plain):
    url, _ = plain
    imgs = [_img(i) for i in range(5)]
    want = json.loads(call(url + "/caption", {"images": imgs})[2])["results"]
    status, headers, body = call(url + "/caption_stream",
                                 {"images": imgs, "chunk": chunk})
    assert status == 200
    assert headers["Content-Type"] == "application/x-ndjson"
    lines = [json.loads(x) for x in body.splitlines()]
    assert lines[-1] == {"done": True, "count": 5}
    assert lines[:-1] == want


@pytest.mark.parametrize("endpoint", ["/caption", "/caption_stream"])
def test_backend_failure_is_500(endpoint):
    def broken(images):
        raise RuntimeError("attention kernel failed: cudaError_t 700")

    with running(broken) as url:
        status, _, body = call(url + endpoint, {"images": [_img()]})
    assert status == 500
    assert "cudaError_t" in json.loads(body)["error"]


def test_overload_sheds_with_429(pinned_flags):
    """A 12-request burst against max_queue 2 at one image a dispatch:
    only 200 and 429, both present, each 429 with Retry-After, the shed
    count equal to the 429s, and the service answers after."""
    params, state = weights()
    handle = PS.build_service(params, state, ModelConfig(**WIDTHS),
                              EvalConfig(**dict(EVAL, beam_size=1)), VOCAB,
                              batch_images=1, microbatch_wait_ms=1.0,
                              max_queue=2, device="cpu")
    run = handle.batcher._run
    handle.batcher._run = lambda xs: (time.sleep(0.25), run(xs))[1]
    img = _img(0)
    with running(handle) as url:
        assert call(url + "/caption", {"images": [img]})[0] == 200
        codes, retry = [], []
        lock = threading.Lock()

        def fire(endpoint):
            status, headers, body = call(url + endpoint, {"images": [img]})
            with lock:
                codes.append(status)
                if status == 429:
                    retry.append(headers.get("Retry-After"))
                    assert json.loads(body)["shed"] is True

        ts = [threading.Thread(target=fire, args=(ep,))
              for ep in ["/caption"] * 8 + ["/caption_stream"] * 4]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=TIMEOUT)
        assert not any(t.is_alive() for t in ts)
        assert len(codes) == 12 and set(codes) == {200, 429}, codes
        assert retry and all(r == "1" for r in retry)
        assert handle.batcher.shed_count == codes.count(429)
        assert call(url + "/caption", {"images": [img]})[0] == 200


def test_per_request_dtype_and_model_routing(registry):
    url, reg = registry
    img = _img(3)
    kar = reg.models["kar"]
    r32 = json.loads(call(url + "/caption", {"images": [img],
                                             "dtype": "float32"})[2])
    assert list(kar._handles) == ["float32"]
    rbf = json.loads(call(url + "/caption", {"images": [img],
                                             "model": "kar",
                                             "dtype": "bfloat16"})[2])
    assert sorted(kar._handles) == ["bfloat16", "float32"]
    assert kar.describe()["compiled_dtypes"] == ["bfloat16", "float32"]
    assert r32["results"][0]["captions"] and rbf["results"][0]["captions"]
    r_def = json.loads(call(url + "/caption", {"images": [img]})[2])
    r_m = json.loads(call(url + "/caption", {"images": [img],
                                             "model": "mrnn"})[2])
    assert r_def == r32
    for res, tag in ((rbf, "k"), (r_def, "k"), (r_m, "m")):
        assert all(w.startswith(tag) for c in res["results"][0]["captions"]
                   for w in c.split())
    # the params were placed once and are shared by both dtypes
    assert len(kar._placed) == 1


def test_stats_after_traffic(registry):
    url, reg = registry
    call(url + "/caption", {"images": [_img(12)], "model": "mrnn"})
    stats = json.loads(call(url + "/stats")[2])
    m = stats["mrnn"]["float32"]
    assert m["requests"] >= 1 and m["images"] >= 1
    assert m["latency_ms"]["p50"] > 0
    rep = m["replicas"][0]
    assert rep["dispatches"] >= 1 and rep["load"] == 0 and rep["shed"] == 0


def test_warmup_runs_the_default_handle_and_clears_stats(registry):
    _, reg = registry
    svc = reg.models["mrnn"]
    handle = svc._handle(svc.default_dtype)
    before = handle.batcher.dispatch_count
    svc.warmup()
    assert handle.batcher.dispatch_count == before + 1
    assert svc.stats()["float32"]["requests"] == 0


def test_least_loaded_routing():
    class FakeBatcher:
        def __init__(self, load):
            self._load = load

        def load(self):
            return self._load

    def handle(tag, batcher):
        h = lambda images: tag     # noqa: E731
        h.batcher = batcher
        return h

    busy, idle = FakeBatcher(8), FakeBatcher(0)
    rs = PS._ReplicaSet([handle("busy", busy), handle("idle", idle)])
    assert [rs([None]) for _ in range(3)] == ["idle"] * 3
    idle._load = 8                 # equal load -> alternate
    assert sorted({rs([None]), rs([None])}) == ["busy", "idle"]


def test_replicas_over_two_cpu_devices(pinned_flags):
    import torch
    params, state = weights()
    kw = dict(default_dtype="float32", batch_images=2,
              microbatch_wait_ms=5.0)
    devs = [torch.device("cpu", 0), torch.device("cpu", 1)]
    rep = PS.ModelService(params, state, ModelConfig(**WIDTHS),
                          EvalConfig(**EVAL), VOCAB, devices=devs, **kw)
    single = PS.ModelService(params, state, ModelConfig(**WIDTHS),
                             EvalConfig(**EVAL), VOCAB, device="cpu", **kw)
    assert rep.describe()["replicas"] == 2
    assert single.describe()["replicas"] == 1
    imgs = [_img(i, seed=40) for i in range(4)]
    assert [rep([im])[0] for im in imgs] == [single([im])[0] for im in imgs]
    handles = rep._handle("float32").handles
    assert [h.batcher.dispatch_count >= 1 for h in handles] == [True, True]
    st = rep.stats()["float32"]
    assert st["requests"] == 4 and len(st["replicas"]) == 2
    assert st["latency_ms"]["p50"] > 0
    before = [h.batcher.dispatch_count for h in handles]
    rep.warmup()
    assert [h.batcher.dispatch_count for h in handles] == \
        [b + 1 for b in before]
    assert rep.stats()["float32"]["requests"] == 0
    assert len(rep._placed) == 2
    rep._handle("bfloat16")
    assert len(rep._placed) == 2


def test_load_registry_from_a_jax_checkpoint(tmp_path, pinned_flags):
    params, state = weights()
    ckpt = str(tmp_path / "srv_ckpt")
    JC.save_checkpoint(ckpt, params, state, None,
                       infos={"iter": 1, "model_type": "Sub_GC_Kar",
                              "model_config": j_config_to_json(
                                  JModelConfig(**WIDTHS)),
                              "vocab": VOCAB},
                       histories={})
    ns = argparse.Namespace(
        model_type="Sub_GC_Kar", checkpoint_path=[f"tiny={ckpt}"],
        bucket=16, batch_images=2, beam_size=3, microbatch_wait_ms=5.0,
        adaptive_wait=False, compute_dtype="float32", replicas=1,
        shard_fanout=1, max_queue=0, device="cpu")
    reg = PS.load_registry(ns)
    assert reg.default == "tiny"
    svc = reg.models["tiny"]
    assert svc.ecfg.max_subgraph_bucket == 16 and svc.ecfg.beam_size == 3
    svc.warmup()
    direct = PS.ModelService(params, state, ModelConfig(**WIDTHS),
                             svc.ecfg, VOCAB, default_dtype="float32",
                             batch_images=2, device="cpu")
    img = _img(42, seed=0)
    out = svc([img])
    assert out[0]["id"] == 42 and out[0]["captions"]
    assert out == direct([img])
    ns.device, ns.replicas = "cuda", 10 ** 6
    with pytest.raises(SystemExit, match="attached devices"):
        PS.load_registry(ns)
