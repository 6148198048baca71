"""The port's bfloat16 chain end to end against the JAX package: both
packages' ``run_test_split`` in ``compute_dtype="bfloat16"`` on the same
synthetic data and weights, Sub_GC_Kar (beam 2, with and without
``bf16_lstm_gates``) and Sub_GC_Flickr_GRD (greedy with attention capture
and a grounding collector), and the entry point's float32 accumulation of
bf16 matmuls.

Bars: identical keep sets, sGPN scores within atol 2e-2 (the bar of
``tests/test_bf16.py``), token agreement >= 0.95.  Observed on this input:
token agreement 1.0 for Sub_GC_Kar in bf16 and in bf16 + gates and for GRD,
scores within 6e-8 (the GCN's bf16 rounding lies below float32 resolution
of its residual at these widths), grounding entries equal; the JAX
package's own jitted, eager and float32 runs agree at 1.0 on such inputs.
"""
import jax
import numpy as np
import pytest
import torch

import subgc_tpu.config as JC
from subgc_tpu.data.dataset import EvalLoader as JEvalLoader
from subgc_tpu.data.synthetic import generate_dataset
from subgc_tpu.eval import grounding as JGrd
from subgc_tpu.eval.runner import run_test_split as j_run_test_split
from subgc_tpu.models.params import init_params as j_init_params
import subgc_tpu_torch as P

from .test_torch_port_slice import _widths
from .test_torch_port_train import one_thread  # noqa: F401


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_bf16")
    return generate_dataset(str(root), n_images=20, vocab_size=50,
                            feat_dim=80, n_subgraphs=12, seed=3)


def _split(synth, tiny_cfg, preset, gates, **run):
    """Both packages' run_test_split in bf16 on the same data and weights;
    returns (port predictions, JAX predictions, port kwargs' results)."""
    over = dict(model={**_widths(tiny_cfg), "compute_dtype": "bfloat16",
                       "bf16_lstm_gates": gates})
    jcfg, jecfg, _ = JC.build_configs(preset, **over)
    cfg, ecfg, _ = P.build_configs(preset, **over)
    paths = dict(input_json=synth["input_json"],
                 input_label_h5=synth["input_label_h5"],
                 sg_dir=synth["sg_dir"], mask_dir=synth["mask_dir"])
    jloader = JEvalLoader(jcfg, JC.DataConfig(**paths), bucket=16)
    loader = P.EvalLoader(cfg, P.DataConfig(**paths), bucket=16)
    params, state = j_init_params(jax.random.PRNGKey(1), jcfg,
                                  n_obj_names=30, n_pred_names=10)
    jrun, prun = run.pop("jax", {}), run.pop("port", {})
    jpreds, _, _ = j_run_test_split(params, state, jloader, jcfg, jecfg,
                                    jloader.vocab, verbose=False,
                                    batch_images=3, keep_tokens=True, **jrun)
    tp = P.params_from_numpy(jax.tree_util.tree_map(np.array, params), "cpu")
    preds, _, _ = P.run_test_split(tp, state, loader, cfg, ecfg,
                                   loader.vocab, verbose=False,
                                   batch_images=3, keep_tokens=True,
                                   device="cpu", **prun)
    return preds, jpreds, loader


def _agreement(preds, jpreds):
    """Identical keep sets and scores within atol 2e-2 per image; returns
    the token agreement over every kept sub-graph, matched by index."""
    assert len(preds) == len(jpreds) > 0
    same = []
    for p, j in zip(preds, jpreds):
        assert p["image_id"] == j["image_id"]
        pi, ji = p["sorted_subgraph_ind"], j["sorted_subgraph_ind"]
        assert sorted(pi.tolist()) == sorted(ji.tolist())
        ps = dict(zip(pi.tolist(), p["subgraph_score"]))
        js = dict(zip(ji.tolist(), j["subgraph_score"]))
        pt = dict(zip(pi.tolist(), p["tokens"]))
        jt = dict(zip(ji.tolist(), j["tokens"]))
        for k in ps:
            assert abs(ps[k] - js[k]) <= 2e-2, (p["image_id"], k)
            same.append((pt[k] == jt[k]).mean())
    return float(np.mean(same))


@pytest.mark.parametrize("gates", [False, True])
def test_run_test_split_bf16_matches_jax(synth, tiny_cfg, gates):
    preds, jpreds, _ = _split(synth, tiny_cfg, "Sub_GC_Kar", gates)
    assert _agreement(preds, jpreds) >= 0.95


def test_grounding_greedy_bf16_matches_jax(synth, tiny_cfg):
    """Sub_GC_Flickr_GRD in bf16 + bf16 gates: greedy with attention
    capture through the per-row kernel's plain version; the collected
    grounding entries equal the JAX package's wherever the captions do."""
    loader = P.EvalLoader(P.ModelConfig(), P.DataConfig(
        input_json=synth["input_json"],
        input_label_h5=synth["input_label_h5"], sg_dir=synth["sg_dir"],
        mask_dir=synth["mask_dir"]), bucket=16)
    words = list(loader.vocab.values())
    lemma_det = {w: i for i, w in enumerate(words[:10])}
    tables = ({w: w for w in words}, lemma_det,
              {i: w for w, i in lemma_det.items()},
              {loader.ds.images[ix]["id"]: (640, 480)
               for ix in loader.split_ix["test"]})
    col, jcol = P.GroundingCollector(*tables), JGrd.GroundingCollector(*tables)
    preds, jpreds, _ = _split(synth, tiny_cfg, "Sub_GC_Flickr_GRD", True,
                              jax=dict(collect_grounding=jcol),
                              port=dict(collect_grounding=col))
    assert _agreement(preds, jpreds) >= 0.95
    same = [str(p["image_id"]) for p, j in zip(preds, jpreds)
            if p["caption"] == j["caption"]]
    assert len(same) >= 0.95 * len(preds)
    for i in same:
        assert col.output[i] == jcol.output[i]


def test_run_test_split_accumulates_bf16_in_float32(monkeypatch, tiny_cfg):
    """Inside the entry point cuBLAS may not reduce bf16 partial sums in
    bf16 (``allow_bf16_reduced_precision_reduction`` off, as the JAX
    package accumulates in float32); the flag is restored after."""
    import chip_smoke as cs
    from subgc_tpu_torch.decode import beam as beam_mod
    cfg, ecfg, _ = P.build_configs("Sub_GC_Kar", model={
        **_widths(tiny_cfg), "compute_dtype": "bfloat16",
        "bf16_lstm_gates": True}, eval=dict(max_subgraph_bucket=16))
    seen = []
    real = beam_mod.beam_search

    def spy(*a, **k):
        seen.append(torch.backends.cuda.matmul
                    .allow_bf16_reduced_precision_reduction)
        out = real(*a, **k)
        # the carried state kept its dtypes; scores and logprobs float32
        assert out.logprobs.dtype == out.all_ps.dtype == torch.float32
        return out

    monkeypatch.setattr(beam_mod, "beam_search", spy)
    flags = torch.backends.cuda.matmul
    monkeypatch.setattr(flags, "allow_bf16_reduced_precision_reduction",
                        True)
    params, state = P.init_params(cfg, seed=3, device="cpu")
    vocab = {str(i): f"w{i}" for i in range(1, cfg.vocab_size + 1)}
    preds, _, _ = P.run_test_split(
        params, state, cs.MemoryLoader(cs.make_examples(cfg, 2, 16, seed=4)),
        cfg, ecfg, vocab, verbose=False, batch_images=2, device="cpu")
    assert seen == [False] and len(preds) == 2
    assert flags.allow_bf16_reduced_precision_reduction is True
