"""``eval/runner.py::run_test_split`` runs its dispatches in two stages
(dispatch k's decode queued, then dispatch k-1's caption text and dispatch
k+1's stacking, then dispatch k's copy back).  Held here against a serial
loop written from the runner's own pieces (``make_batched_infer_fn``,
``_stack_examples``, ``_to_device``, ``_add_predictions``), on the CPU at
tiny Sub-GC widths: the same predictions in the same order (tokens,
scores and keep indices bit for bit, caption strings exact), the same
caption count, the same top-k draws, ``collect_grounding`` calls and
print-out (``verbose``, ``verbose_beam``), for greedy keep-1000, top-k,
beam 2, SCT, attention capture, a padded last dispatch and a one-dispatch
split; and an exception in a dispatch's decode reaches the caller.
"""
import numpy as np
import pytest
import torch

from subgc_tpu_torch.config import EvalConfig, ModelConfig
from subgc_tpu_torch.data import dataset as DS
from subgc_tpu_torch.eval import runner
from subgc_tpu_torch.graph import (make_scene_graph, pad_subgraph_set,
                                   subgraphs_from_masks)
from subgc_tpu_torch.models.params import init_params_numpy, params_from_numpy

CFG = ModelConfig(vocab_size=20, seq_length=8, rnn_size=32,
                  input_encoding_size=24, att_hid_size=16, gcn_dim=20,
                  fc_feat_size=32, att_feat_size=40, embed_dim=10,
                  num_obj_classes=30, num_rel_classes=10, drop_prob_lm=0.0)
VOCAB = {str(i): f"w{i}" for i in range(1, CFG.vocab_size + 1)}
BUCKET = 16

# name: (eval settings, images, images a dispatch)
CASES = {
    "greedy_keep1000": (dict(gpn_max_subg=1000, gpn_nms_thres=0.55), 4, 2),
    "topk": (dict(use_topk_sampling=True, the_k=3, gpn_max_subg=4), 6, 2),
    "beam2_verbose_beam": (dict(beam_size=2, verbose_beam=1,
                                gpn_max_subg=4), 4, 2),
    "sct": (dict(sct=True), 4, 2),
    "return_att": (dict(return_att=True, gpn_max_subg=3), 4, 2),
    "odd_padded": (dict(gpn_max_subg=5), 5, 2),
    "one_dispatch": (dict(gpn_max_subg=4), 2, 2),
}


class _Split:
    def __init__(self, examples):
        self.examples = examples

    def iter_split(self, split="test", num_images=-1):
        return iter(self.examples)


def _examples(n, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        g = make_scene_graph(rng.rand(12, CFG.att_feat_size).astype("f"),
                             rng.rand(12, CFG.num_obj_classes).astype("f"),
                             rng.randint(0, 12, (20, 2)),
                             rng.rand(20, CFG.num_rel_classes).astype("f"))
        n_subs = rng.randint(6, 13)
        subs = pad_subgraph_set(subgraphs_from_masks(
            (rng.rand(n_subs, CFG.obj_num) > 0.7).astype("f"),
            (rng.rand(n_subs, CFG.rel_num) > 0.7).astype("f")), BUCKET)
        out.append(DS.TestExample(
            graph=g, subs=subs, n_subgraphs=n_subs,
            info=DS.ImageInfo(ix=i, id=100 + i, file_path=""),
            gts=np.zeros((0, CFG.seq_length), np.int64), sg_raw={}))
    return out


@pytest.fixture(scope="module")
def weights():
    params, state = init_params_numpy(CFG, seed=0)
    return params_from_numpy(params, "cpu"), params_from_numpy(state, "cpu")


class _Recorder:
    """A ``collect_grounding`` callback that keeps its calls."""

    def __init__(self):
        self.calls = []

    def __call__(self, ex, sents, sorted_ind, att, order):
        self.calls.append((ex.info.id, list(sents), np.copy(sorted_ind),
                           None if att is None else np.copy(att),
                           np.copy(order)))


def _serial(params, state, examples, ecfg, batch, collect):
    """The runner's dispatches one after another: stack, place, encode and
    decode, copy back, caption text."""
    run = runner.make_batched_infer_fn(CFG, ecfg)
    dev = torch.device("cpu")
    generator = torch.Generator(device=dev).manual_seed(2019)
    vb_rng = np.random.RandomState(2019) if ecfg.verbose_beam else None
    preds, n_caps = [], 0
    for i in range(0, len(examples), batch):
        chunk = examples[i:i + batch]
        padded = chunk + [chunk[-1]] * (batch - len(chunk))
        graph, subs = runner._stack_examples(padded)
        out = run(params, state, *runner._to_device(graph, subs, dev),
                  generator)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        n_caps += runner._add_predictions(preds, out, chunk, VOCAB, ecfg,
                                          True, collect, vb_rng, True)
    return preds, n_caps


def _same_arrays(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", list(CASES))
def test_pipelined_split_equals_the_serial_loop(weights, capsys, case):
    settings, n_images, batch = CASES[case]
    ecfg = EvalConfig(max_subgraph_bucket=BUCKET, **settings)
    examples = _examples(n_images, seed=len(case))
    params, state = weights

    ref_rec = _Recorder()
    ref, ref_caps = _serial(params, state, examples, ecfg, batch, ref_rec)
    ref_out = capsys.readouterr().out

    rec = _Recorder()
    got, _, n_caps = runner.run_test_split(
        params, state, _Split(examples), CFG, ecfg, VOCAB, verbose=True,
        batch_images=batch, keep_tokens=True, device="cpu",
        collect_grounding=rec)
    assert capsys.readouterr().out == ref_out

    assert n_caps == ref_caps > 0
    assert [p["image_id"] for p in got] == [ex.info.id for ex in examples]
    assert len(got) == len(ref)
    for p, r in zip(got, ref):
        assert p.keys() == r.keys()
        assert p["image_id"] == r["image_id"]
        assert p["caption"] == r["caption"]
        for k in ("subgraph_score", "sorted_subgraph_ind", "tokens"):
            _same_arrays(p[k], r[k])
    # the decode wrote words, not only end tokens
    assert any(np.any(p["tokens"]) for p in got)

    assert len(rec.calls) == len(ref_rec.calls) == n_images
    for c, r in zip(rec.calls, ref_rec.calls):
        assert c[0] == r[0] and c[1] == r[1]
        _same_arrays(c[2], r[2])
        _same_arrays(c[4], r[4])
        assert (c[3] is None) == (r[3] is None) == (not ecfg.return_att)
        if c[3] is not None:
            _same_arrays(c[3], r[3])
    if ecfg.verbose_beam:
        assert "beam search sentences of image" in ref_out


def test_a_failing_decode_reaches_the_caller(weights, monkeypatch):
    decode = runner._decode
    calls = []

    def fail_second(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("decode failed in the second dispatch")
        return decode(*a, **k)

    monkeypatch.setattr(runner, "_decode", fail_second)
    params, state = weights
    with pytest.raises(RuntimeError, match="second dispatch"):
        runner.run_test_split(
            params, state, _Split(_examples(6)), CFG,
            EvalConfig(gpn_max_subg=4, max_subgraph_bucket=BUCKET), VOCAB,
            verbose=False, batch_images=2, device="cpu")
    assert len(calls) == 2
