"""The port's serving stack (``subgc_tpu_torch/cli/serve.py``) held against
the JAX package's ``subgc_tpu/cli/serve.py`` on the CPU, on the same
weights and requests at the widths of ``tests/test_serve.py``:

* float32 ``ModelService`` (the parity mode), beam 2 and greedy, over
  requests with and without sub-graphs (the on-the-fly bank): the same
  captions in the same order, scores within atol 1e-5;
* bfloat16 (the default service) under the bf16 rules of
  ``tests/test_torch_port_bf16_slice.py``, at the init weights those rules
  were set on: identical keep sets, scores within
  2e-2, token agreement >= 0.95 (tokens and keep sets read from each
  package's batched infer function); at the scaled-up weights the keep
  sets and scores hold too, while a caption whose beam meets a near-tie
  that bf16 rounding flips diverges from there on (measured: 0.914 of
  the tokens agree with JAX's bf16 answer, where JAX's own bf16 and
  float32 answers agree on 0.941), so the token rule is not applied there;
* an image's answer alone equals its answer when coalesced with others
  into one dispatch;
* a float32 and a bf16 dispatch running at the same time on two threads:
  the bf16 matmul flag the server pins stays False throughout;
* the entry points run on the card unless asked for the CPU;
  ``--shard_fanout 2`` excludes ``--replicas 2`` and the cards it lacks,
  and on the CPU serves what the unsharded registry serves
  (``tests/test_torch_port_parallel_serve.py`` holds the sharded service).

The HTTP surface is ``tests/test_torch_port_serve_http.py``.
"""
import argparse
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import subgc_tpu.eval.runner as j_runner
import subgc_tpu_torch.eval.runner as p_runner
from subgc_tpu.cli import serve as JS
from subgc_tpu.config import EvalConfig as JEvalConfig
from subgc_tpu.config import ModelConfig as JModelConfig
from subgc_tpu_torch.cli import serve as PS
from subgc_tpu_torch.config import EvalConfig, ModelConfig, config_to_json
from subgc_tpu_torch.models.params import init_params_numpy
from subgc_tpu_torch.train.checkpoint import save_checkpoint

from .test_torch_port_train import one_thread  # noqa: F401

WIDTHS = dict(vocab_size=30, rnn_size=48, input_encoding_size=32,
              att_hid_size=24, gcn_dim=32, fc_feat_size=48,
              att_feat_size=64, embed_dim=16, num_obj_classes=12,
              num_rel_classes=6)
EVAL = dict(beam_size=2, gpn_nms_thres=0.75, gpn_max_subg=4,
            max_subgraph_bucket=16)
VOCAB = {str(i): f"w{i}" for i in range(1, 31)}


def weights(seed=0, lively=True):
    """The port's numpy init, by default with the LSTM and embedding
    weights scaled up, so that random weights decode varied captions."""
    params, state = init_params_numpy(ModelConfig(**WIDTHS), seed=seed,
                                      n_obj_names=12, n_pred_names=6)
    if not lively:
        return params, state
    dec = params["decoder"]
    for k in ("att_lstm", "lang_lstm"):
        dec[k] = {n: w * 3 if n.startswith("w_") else w
                  for n, w in dec[k].items()}
    dec["embed"] = dec["embed"] * 4
    return params, state


def image(rng, i, with_subgraphs=True, n=8, k=10):
    img = {"id": i,
           "object_fmap": rng.rand(n, WIDTHS["att_feat_size"]).tolist(),
           "object_dist": rng.rand(n, WIDTHS["num_obj_classes"]).tolist(),
           "rel_ind": rng.randint(0, n, (k, 2)).tolist(),
           "pred_dist": rng.rand(k, WIDTHS["num_rel_classes"]).tolist()}
    if with_subgraphs:
        img["subgraphs"] = [
            {"nodes": rng.choice(n, 3, replace=False).tolist(),
             "rels": rng.choice(k, 2, replace=False).tolist()}
            for _ in range(5)]
    return img


def services(default_dtype, ecfg_kw, batch_images=2, lively=True, **kw):
    params, state = weights(lively=lively)
    j = JS.ModelService(jax.tree_util.tree_map(jnp.asarray, params),
                        jax.tree_util.tree_map(jnp.asarray, state),
                        JModelConfig(**WIDTHS), JEvalConfig(**ecfg_kw),
                        VOCAB, default_dtype=default_dtype,
                        batch_images=batch_images, **kw)
    p = PS.ModelService(params, state, ModelConfig(**WIDTHS),
                        EvalConfig(**ecfg_kw), VOCAB,
                        default_dtype=default_dtype,
                        batch_images=batch_images, device="cpu", **kw)
    return j, p


@pytest.fixture
def pinned_flags(monkeypatch):
    """The process-global matmul flags a service pins, restored after."""
    flags = torch.backends.cuda.matmul
    monkeypatch.setattr(flags, "allow_bf16_reduced_precision_reduction",
                        True)
    monkeypatch.setattr(flags, "allow_tf32", flags.allow_tf32)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32",
                        torch.backends.cudnn.allow_tf32)
    return flags


@pytest.mark.parametrize("beam", [2, 1])
def test_float32_service_matches_jax(beam, pinned_flags):
    j, p = services("float32", dict(EVAL, beam_size=beam))
    rng = np.random.RandomState(5)
    imgs = [image(rng, i, with_subgraphs=i != 2) for i in range(5)]
    want, got = j(imgs), p(imgs)
    assert [r["id"] for r in got] == list(range(5))
    words = set()
    for g, w in zip(got, want):
        assert g["captions"] == w["captions"], g["id"]
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=0,
                                   atol=1e-5)
        assert len(g["captions"]) >= 1
        words |= {x for c in g["captions"] for x in c.split()}
    assert len(words) > 3, "degenerate decode"
    assert p.describe() == {**j.describe(), "compiled_dtypes": ["float32"]}


def _spy(module, monkeypatch):
    """Record every dispatch's tokens and keep sets from ``module``'s
    ``make_batched_infer_fn`` (both services build theirs through it)."""
    seen = []
    real = module.make_batched_infer_fn

    def make(*a, **k):
        infer = real(*a, **k)

        def spy(*args):
            out = infer(*args)
            seen.append({key: np.asarray(out[key])
                         for key in ("seq", "scores", "keep_ind",
                                     "keep_valid")})
            return out
        return spy

    monkeypatch.setattr(module, "make_batched_infer_fn", make)
    return seen


@pytest.mark.parametrize("lively", [False, True])
def test_bf16_service_matches_jax_under_the_bf16_rules(lively, monkeypatch,
                                                       pinned_flags):
    j_seen, p_seen = _spy(j_runner, monkeypatch), _spy(p_runner, monkeypatch)
    j, p = services("bfloat16", EVAL, batch_images=4, lively=lively)
    rng = np.random.RandomState(8)
    imgs = [image(rng, i, with_subgraphs=i != 1) for i in range(4)]
    want, got = j(imgs), p(imgs)
    assert len(j_seen) == len(p_seen) == 1
    jo, po = j_seen[0], p_seen[0]
    same = total = 0
    for b in range(4):
        n = int(po["keep_valid"][b].sum())
        assert n == int(jo["keep_valid"][b].sum()) == len(got[b]["captions"])
        assert sorted(po["keep_ind"][b][:n]) == sorted(jo["keep_ind"][b][:n])
        jrow = {int(s): r for r, s in enumerate(jo["keep_ind"][b][:n])}
        for r, s in enumerate(po["keep_ind"][b][:n]):
            assert abs(po["scores"][b][r] - jo["scores"][b][jrow[int(s)]]) \
                <= 2e-2
            a, c = po["seq"][b][r], jo["seq"][b][jrow[int(s)]]
            same += int((a == c).sum())
            total += a.size
        np.testing.assert_allclose(sorted(got[b]["scores"]),
                                   sorted(want[b]["scores"]), atol=2e-2)
    if not lively:
        assert same >= 0.95 * total, same / total
    # the bf16 handle decodes with bf16 gates over image-shared streams
    assert p.describe()["default_dtype"] == "bfloat16"


def test_answer_alone_equals_answer_coalesced(pinned_flags):
    _, p = services("float32", EVAL, batch_images=4,
                    microbatch_wait_ms=300.0)
    rng = np.random.RandomState(3)
    imgs = [image(rng, 100 + i, with_subgraphs=i != 0) for i in range(3)]
    alone = [p([im])[0] for im in imgs]
    handle = p._handle("float32")
    before = handle.batcher.dispatch_count
    out = [None] * 3
    barrier = threading.Barrier(3)

    def fire(i):
        barrier.wait(timeout=30)
        out[i] = p([imgs[i]])[0]

    ts = [threading.Thread(target=fire, args=(i,)) for i in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts)
    assert handle.batcher.dispatch_count - before == 1      # coalesced
    for a, c in zip(alone, out):
        assert a == c


def test_bf16_flag_stays_pinned_while_dtypes_dispatch_concurrently(
        monkeypatch, pinned_flags):
    """A float32 and a bf16 dispatch overlap on two threads: the flag is
    False before, inside and after both (a per-dispatch save and restore
    would switch it back under the other thread)."""
    import subgc_tpu_torch.decode.beam as beam_mod
    real = beam_mod.beam_search
    seen, spans = [], []

    def slow_beam(*a, **k):
        t0 = time.monotonic()
        seen.append(pinned_flags.allow_bf16_reduced_precision_reduction)
        time.sleep(0.3)
        out = real(*a, **k)
        seen.append(pinned_flags.allow_bf16_reduced_precision_reduction)
        spans.append((t0, time.monotonic()))
        return out

    monkeypatch.setattr(beam_mod, "beam_search", slow_beam)
    _, p = services("bfloat16", EVAL)
    assert pinned_flags.allow_bf16_reduced_precision_reduction is False
    p._handle("float32")                    # build it before the race
    rng = np.random.RandomState(4)
    imgs = [image(rng, i) for i in range(2)]
    barrier = threading.Barrier(2)
    out = {}

    def fire(dtype, img):
        barrier.wait(timeout=30)
        out[dtype] = p([img], dtype=dtype)

    ts = [threading.Thread(target=fire, args=(d, im))
          for d, im in zip(("float32", "bfloat16"), imgs)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts)
    assert sorted(out) == ["bfloat16", "float32"]
    (a0, a1), (b0, b1) = spans
    assert a0 < b1 and b0 < a1, "the two dispatches did not overlap"
    assert seen == [False] * 4
    assert pinned_flags.allow_bf16_reduced_precision_reduction is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


def _ns(**kw):
    base = dict(model_type="Sub_GC_Kar", checkpoint_path=[], bucket=16,
                batch_images=2, beam_size=2, microbatch_wait_ms=5.0,
                adaptive_wait=False, compute_dtype="float32", replicas=1,
                shard_fanout=1, max_queue=0, device="cpu")
    return argparse.Namespace(**{**base, **kw})


def test_shard_fanout_is_refused_naming_item_13(tmp_path, monkeypatch,
                                                pinned_flags):
    """``--shard_fanout``, refused until parallelism was ported, now
    serves: it excludes ``--replicas > 1`` and takes at most
    the attached cards, with the JAX server's messages, and on the CPU a
    ``--shard_fanout 2`` registry answers as the unsharded one does."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(SystemExit, match="mutually exclusive"):
        PS.load_registry(_ns(shard_fanout=2, replicas=2, device="cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="--shard_fanout 2 > 1 attached"):
        PS.load_registry(_ns(shard_fanout=2, device="cuda"))
    params, state = weights()
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, params, state, None,
                    {"iter": 1, "model_type": "Sub_GC_Kar",
                     "model_config": config_to_json(ModelConfig(**WIDTHS)),
                     "vocab": VOCAB}, {})
    regs = [PS.load_registry(_ns(checkpoint_path=[f"kar={ckpt}"],
                                 shard_fanout=n)) for n in (2, 1)]
    svc = regs[0].models["kar"]
    assert svc.describe()["fanout_devices"] == 2
    img = image(np.random.RandomState(4), 7)
    assert svc([img]) == regs[1].models["kar"]([img])


def test_service_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params, state = weights()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PS.build_service(params, state, ModelConfig(**WIDTHS),
                         EvalConfig(**EVAL), VOCAB)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PS.ModelService(params, state, ModelConfig(**WIDTHS),
                        EvalConfig(**EVAL), VOCAB)
    assert PS.parse_args(["--checkpoint_path", "x"]).device == "cuda"
    assert PS.parse_args(["--checkpoint_path", "x"]).compute_dtype == \
        "bfloat16"
