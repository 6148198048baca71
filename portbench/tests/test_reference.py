"""The plain reference against the port at small widths on the CPU, on the
benchmark's own seeded weights and traffic: encoder, sGPN scores, NMS keep
sets, decoder log-probabilities, beam and greedy captions, the training
loss with its dropout draws, the gradients and the Adam update."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import small_config, small_traffic
from portbench import weights as W
from portbench.drivers import model_config
from portbench.drivers import test_split as TS
from portbench.drivers import train_loop as TL
from portbench.reference import decode as D
from portbench.reference import train as RT
from portbench.traffic import sampler
from portbench.traffic.train_batch import train_batch

SEED = 2 ** 40 + 9


@pytest.fixture(scope="module")
def kar():
    cfg = small_config("sub_gc.kar_test")
    tr = small_traffic("sub_gc.kar_test")
    w, st = W.make(cfg, SEED, "cpu")
    image = sampler.test_image((SEED, 0, cfg, tr))
    return cfg, tr, w, st, image


def test_encoder_scores_and_nms_match_the_port(kar):
    from subgc_tpu_torch.graph import SceneGraph, SubgraphSet, to_device
    from subgc_tpu_torch.models import encoder as E
    from subgc_tpu_torch.models import gpn as G
    cfg, tr, w, st, image = kar
    mcfg = model_config(cfg)
    graph = to_device(SceneGraph(*image[0]), "cpu")
    subs = to_device(SubgraphSet(*image[1]), "cpu")
    x_port = E.encode_graph(w, st, graph, mcfg)[0]
    x, obj_ind, att_mask, valid, scores, _, mem = TS._score(
        w, st, cfg, image, "cpu")
    torch.testing.assert_close(x, x_port[0], rtol=1e-5, atol=1e-6)
    out = G.gpn_test_forward(w, x_port[0], subs.obj_ind, subs.att_mask, mcfg)
    torch.testing.assert_close(scores, out.scores, rtol=1e-5, atol=1e-6)
    for thres, keep in ((0.75, 10), (0.55, 1000)):
        ind, ok = G.subgraph_nms(out.scores, subs.obj_ind, subs.att_mask,
                                 subs.valid, mcfg, thres, keep)
        ref = D.nms_keep(out.scores, mem, valid, thres, keep)
        assert sorted(ind[ok].tolist()) == sorted(ref)
        assert D.nms_gap(out.scores, mem, valid, ref, thres, keep) == 0.0


@pytest.mark.parametrize("beam", [1, 2])
def test_decode_matches_the_port(kar, beam):
    from subgc_tpu_torch.config import EvalConfig
    from subgc_tpu_torch.eval.runner import run_test_split
    cfg, tr, w, st, image = kar
    ecfg = dict(beam_size=beam, gpn_nms_thres=0.75, gpn_max_subg=10)
    served = TS.serve_reference(w, st, cfg, ecfg, image, "cpu")
    captured = []
    from subgc_tpu_torch.eval import runner
    decode = runner._decode

    def keep(*a, **k):
        res = decode(*a, **k)
        captured.append(res["logprobs"])
        return res

    runner._decode = keep
    try:
        from subgc_tpu_torch.data.dataset import ImageInfo, TestExample
        from subgc_tpu_torch.graph import SceneGraph, SubgraphSet
        ex = TestExample(SceneGraph(*image[0]), SubgraphSet(*image[1]),
                         image[2], ImageInfo(0, 0, ""), None, {})
        preds, _, _ = run_test_split(
            w, st, TS._Split([ex]), model_config(cfg),
            EvalConfig(**ecfg, max_subgraph_bucket=tr["bucket"]),
            {str(i): f"w{i}" for i in range(1, cfg["vocab_size"] + 1)},
            verbose=False, batch_images=1, device="cpu")
    finally:
        runner._decode = decode
    port = TS.served_by_port(preds[0], captured[0], 0, 1, cfg["seq_length"])
    order = np.argsort(served["keep"])
    assert sorted(port["keep"].tolist()) == sorted(served["keep"].tolist())
    by_ind = {int(k): i for i, k in enumerate(port["keep"])}
    rows = [by_ind[int(k)] for k in served["keep"][order]]
    np.testing.assert_array_equal(port["tokens"][rows],
                                  served["tokens"][order])
    np.testing.assert_allclose(port["logprobs"][rows],
                               served["logprobs"][order], atol=1e-5)
    numbers, judged = TS.judge(w, st, cfg, ecfg, image, port, "cpu")
    assert numbers["sgpn_gap"] < 1e-6 and numbers["decode_gap"] < 1e-5
    if beam > 1:
        assert judged > 0 and numbers["beam_gap"] < 1e-4


def test_beam_gap_tells_the_beam_from_greedy_and_the_second_beam(kar):
    cfg, tr, w, st, image = kar
    ecfg = dict(beam_size=2, gpn_nms_thres=0.75, gpn_max_subg=10)
    gaps = {search: TS.judge(w, st, cfg, ecfg, image, TS.serve_reference(
        w, st, cfg, ecfg, image, "cpu", search), "cpu")[0]
        for search in (None, "greedy", "second")}
    assert gaps[None]["beam_gap"] < 1e-4
    # tokens of the best two of their prefixes, log-probabilities the
    # reference's: only the summed log-probability tells these apart
    for search in ("greedy", "second"):
        assert gaps[search]["decode_gap"] < 1e-5
        assert gaps[search]["beam_gap"] > 1e-2, (search, gaps)


@pytest.mark.parametrize("name", ["full_gc.kar_train", "sub_gc.kar_train"])
def test_training_step_matches_the_port(name):
    from subgc_tpu_torch.config import TrainConfig
    from subgc_tpu_torch.graph import SceneGraph
    from subgc_tpu_torch.train import optim
    from subgc_tpu_torch.train import step as S
    cfg, tr = small_config(name), small_traffic(name)
    host = train_batch(SEED, 0, cfg, tr["batch_images"], tr["seq_per_img"],
                       tr["gpn_batch"])
    gen_seed = TL.dropout_seed(SEED)
    # the port: one step from the benchmark's weights
    params, state = W.make(cfg, SEED, "cpu")
    for p in optim.tree_leaves(params):
        p.requires_grad_(True)
    tcfg = TrainConfig(batch_size=tr["batch_images"], **tr["train"])
    ts = S.init_train_state(params, state, tcfg, step=tr["start_iteration"])
    batch = S.batch_to_device(S.TrainBatch(
        graph=SceneGraph(*(host[k] for k in TL.GRAPH_KEYS)),
        **{k: host[k] for k in ("labels", "masks", "sub_obj_ind",
                                "sub_att_mask", "img_ix")}), "cpu")
    grads = []
    ts, metrics = S.make_train_step(model_config(cfg), tcfg, ss_active=False)(
        ts, batch, torch.Generator().manual_seed(gen_seed), 0, 0.0, grads)
    # the reference: the same step
    w, st = W.make(cfg, SEED, "cpu")
    losses, first = RT.run_steps(w, st, cfg, [TL.batch_tensors(host, "cpu")],
                                 gen_seed, tr["train"]["learning_rate"],
                                 cfg["drop_prob_lm"], 1)
    assert abs(losses[0] - float(metrics["loss"])) < 1e-5 * abs(losses[0])
    norm = float(metrics["grad_norm"])
    scale = min(1.0, tcfg.grad_clip_norm / norm)
    port_g = {k: (torch.zeros_like(first[k]) if g is None else g * scale)
              for g, k in zip(grads, first)}
    # Adam moves an element by about lr whatever its gradient's size, so
    # elements whose gradient is round-off move by its sign: compare each
    # leaf's gradient and change in norm, as the check does
    w0, _ = W.make(cfg, SEED, "cpu")
    port = {k: p.detach() - p0 for (k, p), (_, p0)
            in zip(RT.leaves(ts.params), RT.leaves(w0))}
    ref = {k: p - p0 for (k, p), (_, p0) in zip(RT.leaves(w), RT.leaves(w0))}
    gaps = TL.compare(([0.0], port_g, port), ([1.0], first, ref))
    assert gaps["grad_gap"] < 1e-4
    assert TL.norm_gaps(port, ref, TL.kept_leaves(first)) < 0.05
    assert gaps["median_update_gap"] < 0.05
