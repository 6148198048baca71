"""Sharded test decode in the port (``run_test_split(..., mesh=,
shard_axis=)``) on the CPU, over meshes whose 2 or 4 entries are all the
CPU (one thread per entry), held against the port's unsharded run and the
JAX package's ``run_test_split`` over its 8-device mesh
(``make_mesh(n_data=n)``), at tiny widths:

* the image axis (each entry decodes ``batch_images / n`` images of every
  dispatch) and the sub-graph axis (the flat ``[B*Smax]`` decode rows in
  contiguous chunks, uneven where ``n`` does not divide them: 3 images x
  10 rows over 4 entries), for Sub_GC_Kar (beam search, image-shared
  streams) and Sub_GC_MRNN (the greedy fan-out at keep 1000, a chunk that
  starts inside an image);
* captions and ``sorted_subgraph_ind`` equal, sGPN scores rtol 1e-5;
* top-k sampling (Sub_GC_S_MRNN): the tokens do not depend on the shard
  count or axis (every shard draws the unsharded row shape and keeps its
  rows);
* attention capture (Sub_GC_Flickr_GRD, ``return_att`` with a grounding
  collector) and diverse groups (Sub_GC_Kar at beam 2 in 2 groups,
  ``diversity_lambda`` 0.5) on both axes over 2 and 4 entries: captions,
  keep sets, the collector's attention weights (rtol 1e-4 / atol 1e-6, as
  the JAX package's sharded test holds them) and its grounding entries;
* the runner's two ``ValueError``s, with the JAX runner's messages.
"""
import jax
import numpy as np
import pytest
import torch

import subgc_tpu.config as JC
import subgc_tpu_torch as P
from subgc_tpu.data.dataset import EvalLoader as JEvalLoader
from subgc_tpu.data.synthetic import generate_dataset
from subgc_tpu.eval import grounding as JGrd
from subgc_tpu.eval.runner import run_test_split as j_run_test_split
from subgc_tpu.parallel.mesh import make_mesh as j_make_mesh
from subgc_tpu_torch.models.params import init_params_numpy
from subgc_tpu_torch.parallel.mesh import make_mesh

from .test_torch_port_train import one_thread  # noqa: F401

WIDTHS = dict(vocab_size=50, rnn_size=64, input_encoding_size=48,
              att_hid_size=32, gcn_dim=40, fc_feat_size=64,
              att_feat_size=80, embed_dim=20, num_obj_classes=30,
              num_rel_classes=10)
BUCKETS = {"Sub_GC_Kar": 16, "Sub_GC_MRNN": 12, "Sub_GC_S_MRNN": 12,
           "Sub_GC_Flickr_GRD": 16}


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_parallel_eval")
    return generate_dataset(str(root), n_images=30, vocab_size=50,
                            feat_dim=80, n_subgraphs=12, seed=4)


@pytest.fixture(scope="module")
def setups(synth):
    """Per preset: (jax side, port side) loaders, configs and weights."""
    out = {}
    paths = dict(input_json=synth["input_json"],
                 input_label_h5=synth["input_label_h5"],
                 sg_dir=synth["sg_dir"], mask_dir=synth["mask_dir"])
    for preset, bucket in BUCKETS.items():
        jcfg, jecfg, _ = JC.build_configs(preset, model=WIDTHS)
        cfg, ecfg, _ = P.build_configs(preset, model=WIDTHS)
        params, state = init_params_numpy(cfg, seed=1, n_obj_names=30,
                                          n_pred_names=10)
        out[preset] = (
            (jcfg, jecfg, JEvalLoader(jcfg, JC.DataConfig(**paths),
                                      bucket=bucket), params, state),
            (cfg, ecfg, P.EvalLoader(cfg, P.DataConfig(**paths),
                                     bucket=bucket),
             P.params_from_numpy(params, "cpu"),
             P.params_from_numpy(state, "cpu")))
    return out


def _port_run(setup, batch_images, mesh=None, axis="image", ecfg=None,
              collect=None):
    cfg, pecfg, loader, tp, ts = setup
    return P.run_test_split(tp, ts, loader, cfg, ecfg or pecfg, loader.vocab,
                            verbose=False, batch_images=batch_images,
                            device="cpu", mesh=mesh, shard_axis=axis,
                            collect_grounding=collect)


def _same(preds, want):
    assert len(preds) == len(want) > 0
    for p, w in zip(preds, want):
        assert p["image_id"] == w["image_id"]
        assert p["caption"] == w["caption"]
        np.testing.assert_array_equal(p["sorted_subgraph_ind"],
                                      w["sorted_subgraph_ind"])
        np.testing.assert_allclose(p["subgraph_score"], w["subgraph_score"],
                                   rtol=1e-5)


def cpu_mesh(n):
    return make_mesh(devices=[torch.device("cpu")] * n)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("axis", ["image", "subgraph"])
@pytest.mark.parametrize("preset", ["Sub_GC_Kar", "Sub_GC_MRNN"])
def test_sharded_decode_matches_unsharded_and_jax(setups, preset, axis, n):
    jside, pside = setups[preset]
    # the image axis needs batch_images divisible by n; the sub-graph axis
    # takes any (3 images x Smax rows, uneven over 4)
    batch_images = 4 if axis == "image" else 3
    want, _, n_want = _port_run(pside, batch_images)
    got, _, n_got = _port_run(pside, batch_images, cpu_mesh(n), axis)
    assert n_got == n_want
    _same(got, want)
    jcfg, jecfg, jloader, params, state = jside
    assert len(jax.devices()) == 8
    jpreds, _, _ = j_run_test_split(
        params, state, jloader, jcfg, jecfg, jloader.vocab, verbose=False,
        batch_images=batch_images, mesh=j_make_mesh(n_data=n),
        shard_axis=axis)
    _same(got, jpreds)


def test_topk_tokens_do_not_depend_on_the_shard_count(setups):
    _, pside = setups["Sub_GC_S_MRNN"]
    assert pside[1].use_topk_sampling
    want, _, _ = _port_run(pside, 2)
    for mesh, axis in ((cpu_mesh(2), "image"), (cpu_mesh(2), "subgraph"),
                       (cpu_mesh(4), "subgraph")):
        got, _, _ = _port_run(pside, 2, mesh, axis)
        _same(got, want)
    assert len({c for p in want for c in p["caption"]}) > 1


def test_shard_axis_errors_match_the_jax_runner(setups):
    jside, pside = setups["Sub_GC_Kar"]
    jcfg, jecfg, jloader, params, state = jside
    for kw, msg in ((dict(shard_axis="rows", mesh=cpu_mesh(2)),
                     "shard_axis must be 'image' or 'subgraph'"),
                    (dict(shard_axis="subgraph"), "requires a mesh")):
        with pytest.raises(ValueError, match=msg):
            _port_run(pside, 2, kw.get("mesh"), kw["shard_axis"])
        jkw = dict(kw, mesh=j_make_mesh(n_data=2) if "mesh" in kw else None)
        with pytest.raises(ValueError, match=msg):
            j_run_test_split(params, state, jloader, jcfg, jecfg,
                             jloader.vocab, verbose=False, **jkw)


class Recorder:
    """A grounding collector (either package's ``GroundingCollector``) that
    also keeps every call's image, captions, keep set and attention
    weights."""

    def __init__(self, collector):
        self.collector, self.calls = collector, []

    def __call__(self, ex, sents, sorted_ind, att, order):
        self.calls.append((ex.info.id, tuple(sents),
                           tuple(int(i) for i in sorted_ind),
                           None if att is None else np.asarray(att)))
        self.collector(ex, sents, sorted_ind, att, order)


def _grounding_tables(loader):
    words = list(loader.vocab.values())
    lemma_det = {w: i for i, w in enumerate(words[:10])}
    img_wh = {loader.ds.images[ix]["id"]: (640, 480)
              for ix in loader.split_ix["test"]}
    return ({w: w for w in words}, lemma_det,
            {i: w for w, i in lemma_det.items()}, img_wh)


def _same_grounding(got, want):
    assert len(got.calls) == len(want.calls) > 0
    for (ia, sa, ka, aa), (ib, sb, kb, ab) in zip(got.calls, want.calls):
        assert (ia, sa, ka) == (ib, sb, kb)
        assert aa is not None and ab is not None
        np.testing.assert_allclose(aa, ab, rtol=1e-4, atol=1e-6)
    assert dict(got.collector.output) == dict(want.collector.output)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("axis", ["image", "subgraph"])
def test_sharded_grounding_matches_unsharded_and_jax(setups, axis, n):
    jside, pside = setups["Sub_GC_Flickr_GRD"]
    assert pside[1].return_att and pside[1].beam_size == 1
    tables = _grounding_tables(pside[2])
    batch_images = 4 if axis == "image" else 3
    want_rec = Recorder(P.GroundingCollector(*tables))
    want, _, _ = _port_run(pside, batch_images, collect=want_rec)
    got_rec = Recorder(P.GroundingCollector(*tables))
    got, _, _ = _port_run(pside, batch_images, cpu_mesh(n), axis,
                          collect=got_rec)
    _same(got, want)
    _same_grounding(got_rec, want_rec)
    jcfg, jecfg, jloader, params, state = jside
    j_rec = Recorder(JGrd.GroundingCollector(*tables))
    jpreds, _, _ = j_run_test_split(
        params, state, jloader, jcfg, jecfg, jloader.vocab, verbose=False,
        batch_images=batch_images, mesh=j_make_mesh(n_data=n),
        shard_axis=axis, collect_grounding=j_rec)
    _same(got, jpreds)
    _same_grounding(got_rec, j_rec)
    assert sum(len(e[0]["clss"]) for e in got_rec.collector.output.values())


DIVERSE = dict(beam_size=2, group_size=2, diversity_lambda=0.5)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("axis", ["image", "subgraph"])
def test_sharded_diverse_groups_match_unsharded_and_jax(setups, axis, n):
    jside, pside = setups["Sub_GC_Kar"]
    ecfg = pside[1].replace(**DIVERSE)
    batch_images = 4 if axis == "image" else 3
    want, _, _ = _port_run(pside, batch_images, ecfg=ecfg)
    got, _, _ = _port_run(pside, batch_images, cpu_mesh(n), axis, ecfg=ecfg)
    _same(got, want)
    jcfg, jecfg, jloader, params, state = jside
    jpreds, _, _ = j_run_test_split(
        params, state, jloader, jcfg, jecfg.replace(**DIVERSE),
        jloader.vocab, verbose=False, batch_images=batch_images,
        mesh=j_make_mesh(n_data=n), shard_axis=axis)
    _same(got, jpreds)
