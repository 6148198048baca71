"""Caption-serving HTTP endpoint — `python -m subgc_tpu_torch.cli.serve`.

The port's counterpart of ``subgc_tpu/cli/serve.py``, with the same HTTP
surface and status codes.  Loads one or more checkpoints once (either
package's ``model.npz`` + ``infos.json``), builds the attention kernels in a
warmup before the port opens, and serves caption requests over stdlib
HTTP:

    POST /caption
        {"images": [{"id": 1, "object_fmap": [[...]], "object_dist": [[...]],
                     "rel_ind": [[s,o]...], "pred_dist": [[...]],
                     "subgraphs": [{"nodes": [...], "rels": [...]}, ...]}],
         "model": "kar",            # optional; default = first checkpoint
         "dtype": "float32"}        # optional; default = --compute_dtype
    ->  {"results": [{"id": 1, "captions": [...], "scores": [...]}]}

    POST /caption_stream   the same request (plus "chunk", default 8) ->
                           NDJSON, one result line per image, then
                           {"done": true, "count": n}
    GET /healthz -> {"ok": true}
    GET /models  -> {"default": ..., "models": {name: {...}}}
    GET /stats   -> per-model/dtype request+image counts, recent-latency
                    percentiles, per-replica dispatch/queue-load counters

Status codes: 400 for a request the server cannot read (``ValueError``,
``KeyError``, ``TypeError``, bad JSON), 429 + ``Retry-After`` when the
micro-batch queue is full, 500 for any other failure (a kernel that does
not build or launch, say), 404 elsewhere.

Every dispatch decodes a fixed batch of ``batch_images`` images (padded by
repeating the last one), so its GEMM and kernel shapes, and with them an
image's answer, do not depend on how many requests shared it; concurrent
clients' images coalesce into shared dispatches (``utils/microbatch.py``).
The sub-graph list is optional: without it the server samples a bank on
the fly (``data/subgraph_sampler.py``).

Per-request dtype: the float32 params are placed once per device and
shared; each dtype has its own handle and micro-batch queue.  ``bfloat16``
(+ bf16 LSTM gate streams, image-shared attention: ``subgc_shared_
attention_bf16``) is the default deployment path; ``float32`` (per-sub-graph
attention, ``shared_attention``) is the parity mode, token for token the
JAX server's float32 answers.  The non-default dtype's handle is built on
its first request.  The server pins the matmul numerics (TF32 off, bf16
sums in float32) once for the process, since its threads dispatch
concurrently (``device.pin_matmul_numerics``).  ``--replicas N`` places a
copy of each model on ``cuda:0..N-1``, routed least-loaded (throughput).
``--shard_fanout N`` instead gives one model a copy on each of ``cuda:0..
N-1`` and splits every dispatch's sub-graph rows over them, one thread per
card (``eval/runner.py``'s sub-graph axis).  It is meant for latency, but
is slower than one card for now: the threads of a host-bound decode share
one interpreter lock (``PERF.md``).  The two exclude each other.
"""
from __future__ import annotations

import argparse
import json
import os
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..utils.microbatch import QueueFull

_DTYPES = ("float32", "bfloat16")


class LatencyWindow:
    """Sliding window of recent request latencies (seconds) + lifetime
    counters; summarized by the /stats endpoint."""

    def __init__(self, size: int = 256):
        self._samples = deque(maxlen=size)
        self._lock = threading.Lock()
        self.requests = 0
        self.images = 0

    def record(self, seconds: float, n_images: int = 1):
        with self._lock:
            self._samples.append(seconds)
            self.requests += 1
            self.images += n_images

    def reset(self):
        """Drop samples and counters (used after warmup, whose first
        dispatch pays the kernel build and one-time setup and would
        otherwise poison the recent-latency percentiles)."""
        with self._lock:
            self._samples.clear()
            self.requests = 0
            self.images = 0

    def snapshot(self) -> tuple:
        """(requests, images, [samples]) under the lock."""
        with self._lock:
            return self.requests, self.images, list(self._samples)

    @staticmethod
    def summarize(samples) -> dict:
        s = sorted(samples)
        n = len(s)
        if not n:
            return {}
        return {"mean": round(1e3 * sum(s) / n, 2),
                "p50": round(1e3 * s[n // 2], 2),
                "p90": round(1e3 * s[min(n - 1, int(n * 0.9))], 2)}

    def summary(self) -> dict:
        requests, images, samples = self.snapshot()
        out = {"requests": requests, "images": images}
        lat = self.summarize(samples)
        if lat:
            out["latency_ms"] = lat
        return out


def parse_checkpoint_spec(spec: str) -> tuple:
    """Split a ``--checkpoint_path`` value into ``(name, path)``.

    Accepts ``NAME=dir`` but never mis-splits a plain path that contains
    ``'='`` (e.g. sweep dirs like ``/ckpts/lr=5e-4/run``): the prefix must
    look like a name (no path separator) and the whole spec must not itself
    be an existing directory.  A missing name defaults to the path's
    basename."""
    name, eq, rest = spec.partition("=")
    if eq and os.sep not in name and not os.path.isdir(spec):
        path = rest
    else:
        name, path = "", spec
    return name or os.path.basename(os.path.normpath(path)), path


def _place(tree, device):
    """A params/state tree (numpy arrays or tensors) on ``device``; tensors
    already there are shared, not copied."""
    import torch

    from ..models.params import params_from_numpy
    from ..train.optim import tree_map
    return tree_map(lambda x: x.to(device) if isinstance(x, torch.Tensor)
                    else params_from_numpy(x, device), tree)


def build_service(params, state, mcfg, ecfg, vocab, batch_images: int = 8,
                  microbatch_wait_ms: float = 3.0,
                  adaptive_wait: bool = False, device=None,
                  max_queue: int = 0, mesh=None):
    """Returns handle(images_payload) -> results list.

    Concurrent requests coalesce into shared dispatches via MicroBatcher;
    every dispatch decodes ``batch_images`` images, padded by repeating the
    last, through ``eval/runner.py::make_batched_infer_fn`` on ``device``
    (the card unless the caller asks for the CPU; no fallback).  ``params``
    and ``state`` are numpy or tensor trees, placed on ``device`` once.

    mesh (a ``parallel.mesh.Mesh``; exclusive with ``device``): one model
    copy per mesh device (``params``/``state`` may come as that list
    already), each dispatch's fan-out rows sharded over the mesh (the
    latency scale-out, complementary to replicas).

    handle.batcher (dispatch counters), handle.latency (/stats) and
    handle.to_example (a request image -> the padded (graph, subs) pair a
    dispatch stacks) are exposed for observability."""
    import torch

    from ..data.subgraph_sampler import sample_subgraph_bank
    from ..device import pin_matmul_numerics, resolve_device
    from ..eval.runner import make_batched_infer_fn
    from ..graph import (SceneGraph, SubgraphSet, make_scene_graph,
                         pad_subgraph_set, subgraphs_from_masks, to_device)
    from ..utils.microbatch import MicroBatcher
    from ..utils.text import decode_sequence

    if device is not None and mesh is not None:
        raise ValueError("device and mesh are mutually exclusive")
    pin_matmul_numerics()
    infer = make_batched_infer_fn(mcfg, ecfg, mesh=mesh)
    if mesh is None:
        dev = resolve_device(device or "cuda")
        params, state = _place(params, dev), _place(state, dev)
    else:
        dev = resolve_device(mesh.devices[0])
        if not isinstance(params, list):
            params = [_place(params, d) for d in mesh.devices]
            state = [_place(state, d) for d in mesh.devices]
    bucket = ecfg.max_subgraph_bucket

    def to_example(img):
        graph = make_scene_graph(
            np.asarray(img["object_fmap"], np.float32),
            np.asarray(img["object_dist"], np.float32),
            np.asarray(img["rel_ind"], np.int64),
            np.asarray(img["pred_dist"], np.float32),
            mcfg.obj_num, mcfg.rel_num)
        if img.get("subgraphs"):
            obj_masks = np.zeros((len(img["subgraphs"]), mcfg.obj_num - 1))
            pred_masks = np.zeros((len(img["subgraphs"]), mcfg.rel_num - 1))
            for i, sg in enumerate(img["subgraphs"]):
                obj_masks[i, np.asarray(sg["nodes"], int)] = 1
                pred_masks[i, np.asarray(sg.get("rels", []), int)] = 1
            subs = subgraphs_from_masks(obj_masks, pred_masks,
                                        mcfg.obj_num, mcfg.rel_num)
        else:
            n = np.asarray(img["object_fmap"]).shape[0]
            bank = sample_subgraph_bank(
                n, np.asarray(img["rel_ind"], np.int64),
                [np.arange(min(2, n))] * 5,
                n_samples=min(bucket - 5, 64))
            masks = bank["subgraph_mask_list"][5:]
            obj_masks = np.stack([m[1][:mcfg.obj_num - 1] for m in masks])
            pred_masks = np.stack([m[2][:mcfg.rel_num - 1] for m in masks])
            subs = subgraphs_from_masks(obj_masks, pred_masks,
                                        mcfg.obj_num, mcfg.rel_num)
        return graph, pad_subgraph_set(subs, bucket)

    def run_batch(examples):
        """examples: 1..batch_images (graph, subs) pairs -> per-example
        {'seq','scores','keep_valid','keep_ind'} numpy dicts.  Padding
        slots repeat the last example and are discarded; with the batch
        fixed, each image's outputs are independent of what shared its
        dispatch."""
        n_real = len(examples)
        examples = list(examples)
        while len(examples) < batch_images:
            examples.append(examples[-1])
        graph = SceneGraph(*[np.concatenate([g[0][i] for g in examples])
                             for i in range(4)])
        subs = SubgraphSet(*[np.stack([np.asarray(g[1][i]) for g in examples])
                             for i in range(4)])
        # the top-k draws start from seed 0 in every dispatch, as the JAX
        # server passes PRNGKey(0)
        gen = (torch.Generator(device=dev).manual_seed(0)
               if ecfg.beam_size <= 1 else None)
        out = infer(params, state, to_device(graph, dev),
                    to_device(subs, dev), gen)
        # one device-to-host copy per dispatch: every field is exact in
        # float64 (token and sub-graph ids, float32 scores, flags)
        keys = ("seq", "scores", "keep_valid", "keep_ind")
        flat = [out[k].reshape(batch_images, -1) for k in keys]
        host = torch.cat([t.double() for t in flat], 1).cpu().numpy()
        cuts = np.cumsum([t.shape[1] for t in flat])[:-1]
        fields = {k: part.reshape(out[k].shape).astype(
            np.float32 if k == "scores" else
            bool if k == "keep_valid" else np.int64)
            for k, part in zip(keys, np.split(host, cuts, axis=1))}
        return [{k: v[bi] for k, v in fields.items()}
                for bi in range(n_real)]

    batcher = MicroBatcher(run_batch, max_batch=batch_images,
                           max_wait_ms=microbatch_wait_ms,
                           adaptive=adaptive_wait, max_queue=max_queue)

    latency = LatencyWindow()

    def handle(images):
        # one atomic submit: the batcher splits the items into
        # <=batch_images dispatches itself, other clients' images share
        # them, and with max_queue set admission is all-or-nothing (no
        # half-served request burns a dispatch before being shed)
        t0 = time.monotonic()
        outs = batcher.submit_many([to_example(img) for img in images])
        results = []
        for img, out in zip(images, outs):
            n = int(out["keep_valid"].sum())
            order = np.argsort(-out["scores"][:n], kind="stable")
            sents = decode_sequence(vocab, out["seq"][:n][order])
            results.append({"id": img.get("id", len(results)),
                            "captions": sents,
                            "scores": out["scores"][:n][order].tolist()})
        latency.record(time.monotonic() - t0, len(images))
        return results

    handle.batcher = batcher
    handle.latency = latency
    handle.to_example = to_example
    return handle


class _ReplicaSet:
    """Least-loaded dispatcher over per-device service handles.

    Each replica keeps its own MicroBatcher, so concurrent requests
    coalesce per card and the cards run in parallel; a request's images all
    go to one replica.  Routing picks the replica with the lowest
    instantaneous queue pressure (MicroBatcher.load), breaking ties
    round-robin so idle replicas interleave.  Exposes .batcher (first
    replica's, for the single-replica observability contract) and
    .handles."""

    def __init__(self, handles):
        self.handles = list(handles)
        self._next = 0
        self._lock = threading.Lock()

    @property
    def batcher(self):
        return self.handles[0].batcher

    def __call__(self, images):
        loads = [h.batcher.load() for h in self.handles]
        lo = min(loads)
        candidates = [i for i, l in enumerate(loads) if l == lo]
        with self._lock:
            i = candidates[self._next % len(candidates)]
            self._next += 1
        return self.handles[i](images)


class ModelService:
    """One loaded checkpoint servable under per-request compute dtype.

    Holds the float32 params once per device; builds one `build_service`
    handle per requested dtype (each its own MicroBatcher: requests of two
    dtypes cannot share a dispatch).  The default dtype's handle is built
    here; call :meth:`warmup` (the CLI does, before opening the port) to
    build the kernels and pay the first dispatch up front.  The other
    dtype's handle is built on its first request.

    devices: one service replica per ``torch.device`` (params copied to
    each), requests routed least-loaded; None serves one replica on
    ``device`` (the card unless the caller asks for the CPU).

    mesh: a ``parallel.mesh.Mesh`` - one model copy per mesh device, each
    dispatch's sub-graph fan-out rows sharded across the mesh (latency
    scale-out); exclusive with ``devices`` and with ``device``.
    """

    def __init__(self, params, state, mcfg, ecfg, vocab,
                 default_dtype: str = "bfloat16", batch_images: int = 8,
                 microbatch_wait_ms: float = 3.0,
                 adaptive_wait: bool = False, devices=None, device=None,
                 max_queue: int = 0, mesh=None):
        import torch

        from ..device import resolve_device
        if default_dtype not in _DTYPES:
            raise ValueError(f"default_dtype must be one of {_DTYPES}")
        if devices is not None and len(devices) == 0:
            raise ValueError("devices must be None or non-empty")
        if devices is not None and mesh is not None:
            raise ValueError("devices (replicas) and mesh (fan-out "
                             "sharding) are mutually exclusive")
        if device is not None and mesh is not None:
            raise ValueError("device and mesh are mutually exclusive")
        self.mesh = mesh
        self.params, self.state, self.vocab = params, state, vocab
        # base config with dtype fields neutralized; variants derive from it
        self.mcfg = mcfg.replace(compute_dtype="float32",
                                 bf16_lstm_gates=False)
        self.ecfg = ecfg
        self.default_dtype = default_dtype
        self.devices = ([torch.device(d) for d in devices]
                        if devices is not None else None)
        self._targets = (self.devices or
                         [resolve_device(mesh.devices[0] if mesh is not None
                                         else device or "cuda")])
        self._kw = dict(batch_images=batch_images,
                        microbatch_wait_ms=microbatch_wait_ms,
                        adaptive_wait=adaptive_wait, max_queue=max_queue)
        self._handles = {}
        self._placed = {}       # device -> (params, state), shared by dtypes
        self._lock = threading.Lock()
        self._handle(default_dtype)

    def _params_on(self, device):
        """Params/state placed on `device` ONCE — the per-dtype handles
        share the same float32 copy (the bf16 chain casts per call), so a
        second dtype costs no extra device memory or transfer."""
        if device not in self._placed:
            self._placed[device] = (_place(self.params, device),
                                    _place(self.state, device))
        return self._placed[device]

    def _handle(self, dtype: str):
        with self._lock:
            if dtype not in self._handles:
                # float32 is the parity mode: it also keeps the
                # per-sub-graph attention layout (the image-shared one is
                # token-exact but reassociates float sums)
                mcfg = self.mcfg.replace(
                    compute_dtype=dtype,
                    bf16_lstm_gates=dtype == "bfloat16",
                    share_att_images=dtype == "bfloat16")
                if self.mesh is not None:
                    placed = [self._params_on(d) for d in self.mesh.devices]
                    self._handles[dtype] = build_service(
                        [p for p, _ in placed], [s for _, s in placed],
                        mcfg, self.ecfg, self.vocab, mesh=self.mesh,
                        **self._kw)
                    return self._handles[dtype]
                handles = [build_service(*self._params_on(d), mcfg,
                                         self.ecfg, self.vocab, device=d,
                                         **self._kw)
                           for d in self._targets]
                self._handles[dtype] = (handles[0] if self.devices is None
                                        else _ReplicaSet(handles))
            return self._handles[dtype]

    def __call__(self, images, dtype: str | None = None):
        dtype = dtype or self.default_dtype
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {_DTYPES}, got {dtype!r}")
        return self._handle(dtype)(images)

    def warmup(self):
        """Run one dummy image through the default-dtype handle (per
        replica), so that the first real request pays neither the kernels'
        build nor the first dispatch's setup; a kernel that does not build
        or launch fails here, before the port opens."""
        mcfg, n, k = self.mcfg, 4, 3
        rng = np.random.RandomState(0)
        for _ in self._targets:
            self([{"object_fmap": rng.rand(n, mcfg.att_feat_size),
                   "object_dist": rng.rand(n, mcfg.num_obj_classes),
                   "rel_ind": rng.randint(0, n, (k, 2)),
                   "pred_dist": rng.rand(k, mcfg.num_rel_classes),
                   "subgraphs": [{"nodes": [0, 1], "rels": [0]}]}])
        # the warmup's samples would read as served traffic in /stats
        h = self._handles[self.default_dtype]
        for r in (h.handles if isinstance(h, _ReplicaSet) else [h]):
            r.latency.reset()

    def describe(self) -> dict:
        return {"default_dtype": self.default_dtype,
                "compiled_dtypes": sorted(self._handles),
                "beam_size": self.ecfg.beam_size,
                "bucket": self.ecfg.max_subgraph_bucket,
                "vocab_size": self.mcfg.vocab_size,
                "replicas": len(self.devices) if self.devices else 1,
                "fanout_devices": self.mesh.size if self.mesh else 1}

    def stats(self) -> dict:
        """Per-dtype serving counters for GET /stats: request/image counts,
        recent-latency percentiles, per-replica dispatch/item counts."""
        out = {}
        with self._lock:
            handles = dict(self._handles)
        for dtype, h in handles.items():
            reps = h.handles if isinstance(h, _ReplicaSet) else [h]
            d = {"replicas": [{"dispatches": r.batcher.dispatch_count,
                               "images": r.batcher.item_count,
                               "load": r.batcher.load(),
                               "shed": r.batcher.shed_count} for r in reps]}
            snaps = [r.latency.snapshot() for r in reps]
            d["requests"] = sum(s[0] for s in snaps)
            d["images"] = sum(s[1] for s in snaps)
            # one schema regardless of replica count: percentiles over the
            # merged recent-sample windows
            lat = LatencyWindow.summarize(
                [x for s in snaps for x in s[2]])
            if lat:
                d["latency_ms"] = lat
            out[dtype] = d
        return out


class ModelRegistry:
    """Several ModelServices behind one endpoint, routed by request
    `model`; the first registered model is the default."""

    def __init__(self):
        self.models: dict = {}
        self.default = None

    def add(self, name: str, service: ModelService):
        if name in self.models:
            raise ValueError(f"duplicate model name {name!r}")
        self.models[name] = service
        if self.default is None:
            self.default = name

    def __call__(self, images, model: str | None = None,
                 dtype: str | None = None):
        name = model or self.default
        if name not in self.models:
            raise ValueError(f"unknown model {name!r}; available: "
                             f"{sorted(self.models)}")
        return self.models[name](images, dtype=dtype)

    def describe(self) -> dict:
        return {"default": self.default,
                "models": {n: s.describe() for n, s in self.models.items()}}

    def stats(self) -> dict:
        return {n: s.stats() for n, s in self.models.items()}


class _Handler(BaseHTTPRequestHandler):
    service = None

    def log_message(self, *a):      # quiet
        pass

    def _reply(self, code, payload):
        blob = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(blob)))
        self.end_headers()
        self.wfile.write(blob)

    def do_GET(self):
        if self.path == "/healthz":
            self._reply(200, {"ok": True})
        elif self.path == "/models" and hasattr(self.service, "describe"):
            self._reply(200, self.service.describe())
        elif self.path == "/stats" and hasattr(self.service, "stats"):
            self._reply(200, self.service.stats())
        else:
            self._reply(404, {"error": "not found"})

    def do_POST(self):
        if self.path not in ("/caption", "/caption_stream"):
            self._reply(404, {"error": "not found"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length))
            images = req["images"]
            if not isinstance(images, list):
                raise ValueError("images must be a list")
            chunk = 8
            if self.path == "/caption_stream":
                # chunk only shapes streaming granularity; /caption
                # ignores it (single dispatch), so don't 400 on it there
                raw_chunk = req.get("chunk", 8)
                if not isinstance(raw_chunk, int) or isinstance(
                        raw_chunk, bool) or raw_chunk < 1:
                    raise ValueError("chunk must be a positive integer")
                chunk = raw_chunk
            service = self.service
            if isinstance(service, (ModelRegistry, ModelService)):
                kw = {"dtype": req.get("dtype")}
                if kw["dtype"] is not None and kw["dtype"] not in _DTYPES:
                    raise ValueError(f"dtype must be one of {_DTYPES}")
                if isinstance(service, ModelRegistry):
                    kw["model"] = req.get("model")
                    name = kw["model"] or service.default
                    if name not in service.models:
                        raise ValueError(f"unknown model {name!r}; "
                                         f"available: "
                                         f"{sorted(service.models)}")
                call = lambda imgs: service(imgs, **kw)
            else:               # plain build_service handle
                for field in ("dtype", "model"):
                    if req.get(field) is not None:
                        raise ValueError(
                            f"per-request {field!r} requires a "
                            f"ModelService/ModelRegistry backend; this "
                            f"endpoint serves a single fixed model")
                call = service
            if self.path == "/caption":
                self._reply(200, {"results": call(images)})
                return
            # /caption_stream: compute the FIRST chunk before committing to
            # a 200 — overload (QueueFull) and first-dispatch failures shed
            # as proper status codes instead of a 200 + error trailer
            first = call(images[:chunk]) if images else []
        except QueueFull as e:
            self.send_response(429)
            self.send_header("Content-Type", "application/json")
            self.send_header("Retry-After", "1")
            blob = json.dumps({"error": str(e), "shed": True}).encode()
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)
            return
        except (ValueError, KeyError, TypeError,
                json.JSONDecodeError) as e:
            # request validation: malformed payloads surface from the
            # service as KeyError/ValueError too
            self._reply(400, {"error": repr(e)})
            return
        except Exception as e:
            # anything else is a server-side failure (a kernel that does
            # not build or launch, the device), not a client fault — 4xx
            # would tell well-behaved clients not to retry a valid request
            self._reply(500, {"error": repr(e)})
            return
        # /caption_stream: NDJSON, one result line per image, flushed per
        # chunk as its dispatch drains.  Everything knowable up front
        # (payload shape, chunk, model, dtype, admission of the first
        # chunk) was resolved above so bad requests still get real status
        # codes; only mid-decode failures downgrade to the error trailer.
        # No Content-Length: the HTTP/1.0 stream ends when the connection
        # closes, after the {"done":...} trailer.
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.end_headers()
        n = 0
        try:
            for r in first:
                self.wfile.write((json.dumps(r) + "\n").encode())
                n += 1
            self.wfile.flush()
            for i in range(chunk, len(images), chunk):
                for r in call(images[i:i + chunk]):
                    self.wfile.write((json.dumps(r) + "\n").encode())
                    n += 1
                self.wfile.flush()
            tail = {"done": True, "count": n}
        except Exception as e:      # headers already sent: error trailer
            tail = {"done": False, "count": n, "error": repr(e),
                    "shed": isinstance(e, QueueFull)}
        try:
            self.wfile.write((json.dumps(tail) + "\n").encode())
        except OSError:             # client hung up mid-stream: normal
            pass


class _Server(ThreadingHTTPServer):
    # clients that connect at the same moment queue in the listen backlog;
    # socketserver's default of 5 would drop the rest's handshakes, and
    # their retransmits would add a second to their latency
    request_queue_size = 128


def serve(service, host: str = "127.0.0.1", port: int = 8742):
    # per-server handler subclass: several serve() calls in one process
    # (tests, multi-port deployments) must not hijack each other's service
    # through the shared _Handler class attribute
    # staticmethod: a plain-function service stored as a class attribute
    # would otherwise bind as a method and receive the handler as `self`
    handler = type("_BoundHandler", (_Handler,),
                   {"service": staticmethod(service)})
    return _Server((host, port), handler)


def load_registry(args) -> ModelRegistry:
    """Build the ModelRegistry from parsed CLI args: one ModelService per
    --checkpoint_path spec, configs from each checkpoint's infos.json
    (checkpoint-authoritative, like cli/test.py), params from its
    model.npz (either package's), optional replicas on cuda:0..N-1 or a
    --shard_fanout mesh over cuda:0..N-1 (on --device cpu, N entries of
    the CPU)."""
    import torch

    from ..config import ModelConfig, build_configs, config_from_json
    from ..models.params import load_model_npz
    from ..parallel.mesh import make_mesh

    device = getattr(args, "device", "cuda")
    on_card = torch.device(device).type == "cuda"
    devices = None
    if args.replicas > 1:
        avail = torch.cuda.device_count() if on_card else 1
        if args.replicas > avail:
            raise SystemExit(f"--replicas {args.replicas} > {avail} "
                             f"attached devices")
        devices = [torch.device("cuda", i) for i in range(args.replicas)]
    mesh = None
    fanout = getattr(args, "shard_fanout", 1)
    if fanout > 1:
        if devices is not None:
            raise SystemExit("--shard_fanout and --replicas > 1 are "
                             "mutually exclusive (latency vs throughput "
                             "scale-out)")
        if on_card:
            avail = torch.cuda.device_count()
            if fanout > avail:
                raise SystemExit(f"--shard_fanout {fanout} > {avail} "
                                 f"attached devices")
            mesh = make_mesh(n_data=fanout)
        else:
            mesh = make_mesh(devices=[device] * fanout)

    registry = ModelRegistry()
    for spec in args.checkpoint_path:
        name, path = parse_checkpoint_spec(spec)
        with open(os.path.join(path, "infos.json")) as f:
            infos = json.load(f)
        _, ecfg, _ = build_configs(infos.get("model_type", args.model_type),
                                   mode="test")
        mcfg = config_from_json(ModelConfig, infos["model_config"])
        ecfg = ecfg.replace(max_subgraph_bucket=args.bucket)
        if args.beam_size:
            ecfg = ecfg.replace(beam_size=args.beam_size)
        blob = load_model_npz(os.path.join(path, "model.npz"))
        registry.add(name, ModelService(
            blob["params"], blob["state"], mcfg, ecfg, infos["vocab"],
            default_dtype=args.compute_dtype,
            batch_images=args.batch_images,
            microbatch_wait_ms=args.microbatch_wait_ms,
            adaptive_wait=args.adaptive_wait, devices=devices,
            device=None if mesh is not None else device,
            max_queue=getattr(args, "max_queue", 0), mesh=mesh))
    return registry


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("model_type", nargs="?", default="Sub_GC_Kar",
                   help="eval-preset fallback for checkpoints whose "
                        "infos.json predates the model_type field")
    p.add_argument("--checkpoint_path", type=str, required=True,
                   action="append",
                   help="checkpoint dir, or NAME=dir; repeatable — each "
                        "becomes a servable model routed by the request's "
                        "'model' field (first one is the default)")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8742)
    p.add_argument("--bucket", type=int, default=128)
    p.add_argument("--batch_images", type=int, default=8)
    p.add_argument("--beam_size", type=int, default=None)
    p.add_argument("--microbatch_wait_ms", type=float, default=3.0,
                   help="how long a dispatch waits for more requests to "
                        "coalesce before running under-full")
    p.add_argument("--adaptive_wait", action="store_true",
                   help="tune the fill window from the observed arrival "
                        "rate (microbatch_wait_ms becomes the cap)")
    p.add_argument("--replicas", type=int, default=1,
                   help="serve N copies of each model, one per card "
                        "(cuda:0..N-1), requests routed least-loaded")
    p.add_argument("--shard_fanout", type=int, default=1,
                   help="shard each dispatch's sub-graph fan-out over N "
                        "cards, one thread per card (slower than one card "
                        "until a process per card lands); exclusive with "
                        "--replicas")
    p.add_argument("--max_queue", type=int, default=256,
                   help="overload protection: per-model-queue cap on queued"
                        " + in-flight images; a request that would exceed "
                        "it is shed with HTTP 429 + Retry-After.  Must "
                        "exceed the largest single request (stream bigger "
                        "ones in chunks).  0 = unbounded")
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=list(_DTYPES),
                   help="default serving dtype; bfloat16 (+ bf16 LSTM gate "
                        "streams) is the deployment config, float32 the "
                        "parity mode")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    registry = load_registry(args)

    for name, svc in registry.models.items():
        print(f"warming {name} ({svc.default_dtype})...", flush=True)
        svc.warmup()

    httpd = serve(registry, args.host, args.port)
    parity = ("default answers are not token-for-token the float32 ones; "
              'per-request {"dtype": "float32"} (or --compute_dtype '
              "float32) is the parity mode"
              if args.compute_dtype == "bfloat16" else "parity mode")
    print(f"serving {sorted(registry.models)} on "
          f"http://{args.host}:{args.port} "
          f"(default {registry.default}, bucket {args.bucket}, "
          f"default dtype={args.compute_dtype} — {parity})", flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()
