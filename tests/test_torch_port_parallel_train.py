"""The port's data-parallel train step over ``torch.distributed`` (gloo
ranks on the CPU) held against the port's single-process step, at tiny
widths (``tests/test_torch_port_parallel_train_jax.py`` holds it against
the JAX package's 8-device mesh step).

Ranks are spawned twice per module (2 and 4 ranks), each running every
spec below (``parallel/steps.py``), so that the file stays short.  Cases:
an sGPN config (Sub-GC), Full-GC with its GCN BatchNorm synced across the
ranks, and ``use_bn=1``; two steps each (the hoisted one, then scheduled
sampling at 0.25) with dropout on, from iteration 0 (LR 0, then the
warmup), a val pass, and for Sub-GC an SCST step (the rewards scored on the
gathered global batch).  The batches' sentences have random lengths, so
the ranks' token counts differ.

Tolerances: every metric (losses, gradient norm) rtol 1e-5; the gradients
the optimizer gets in the first step with a learning rate above 0, summed
over the ranks, rtol 2e-4 of the L2 norm, both as one vector and leaf by
leaf, and the leaves whose gradient is zero in exact arithmetic (the
attention's logit bias, the biases BatchNorm cancels) float noise in both
runs (below 1e-5 of the whole gradient's norm); parameters and running
statistics rtol 2e-4 / atol 1e-6 (JAX's own sharded-vs-single tolerance,
``tests/test_train.py``), except those zero-gradient leaves, which Adam
moves by the sign of their noise; the global val loss rtol 1e-6; SCST
loss and mean reward rtol 1e-5; the parameters bitwise equal across the
ranks (checksums).  Each spec also runs with dropout
off (no generator, ``drop_prob_lm=0``), the hoisted step twice.
"""
from dataclasses import asdict

import numpy as np
import pytest
import torch

from subgc_tpu_torch.config import ModelConfig, TrainConfig
from subgc_tpu_torch.data.synthetic import synthetic_train_batch
from subgc_tpu_torch.models.params import init_params_numpy
from subgc_tpu_torch.parallel import steps as PS

WIDTHS = dict(vocab_size=50, seq_length=16, rnn_size=64,
              input_encoding_size=48, att_hid_size=32, gcn_dim=40,
              fc_feat_size=64, att_feat_size=80, embed_dim=20,
              num_obj_classes=30, num_rel_classes=10)
FULL_GC = dict(noun_fuse=False, pred_emb_type=2, gcn_layers=4,
               gcn_residual=1, gcn_bn=True, use_gpn=False)
CASES = {"sub_gc": {}, "full_gc": FULL_GC, "use_bn1": dict(use_bn=1)}
B = 8                       # images: JAX's 8-device mesh splits them
WORLDS = (2, 4)


def train_batch(cfg, seed):
    """synthetic_train_batch with random sentence lengths (3..13 tokens)."""
    b = synthetic_train_batch(cfg, B, seed)
    L = np.random.RandomState(seed + 100).randint(3, 14, b.masks.shape[0])
    m = np.arange(b.masks.shape[1])[None] < L[:, None]
    return b._replace(masks=m.astype(np.float32))


def _spec(case, dropout):
    cfg = ModelConfig(**WIDTHS, **CASES[case],
                      **({} if dropout else dict(drop_prob_lm=0.0)))
    spec = dict(cfg=asdict(cfg), tcfg=asdict(TrainConfig(batch_size=B)),
                params=init_params_numpy(cfg, seed=3),
                batches=[train_batch(cfg, 1), train_batch(cfg, 2)],
                steps=[None, 0.25] if dropout else [None, None],
                seed=7 if dropout else None,
                val_batch=train_batch(cfg, 9), grads=True)
    if case == "sub_gc" and dropout:
        sb = train_batch(cfg, 11)
        rng = np.random.RandomState(12)
        gts = [rng.randint(1, cfg.vocab_size, (5, cfg.seq_length))
               for _ in range(B * 5)]
        spec["scst"] = (sb, gts, {str(i): f"w{i}"
                                  for i in range(1, cfg.vocab_size + 1)})
    return spec


SPECS = [(case, dropout) for dropout in (True, False) for case in CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: reports[rank][spec]} for 2 and 4 gloo ranks, and the
    single-process reports of the same specs."""
    specs = [_spec(c, d) for c, d in SPECS]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        single = [PS.run_steps(s, "cpu") for s in specs]
    finally:
        torch.set_num_threads(n)
    out = {}
    for world in WORLDS:
        d = tmp_path_factory.mktemp(f"ranks{world}")
        out[world] = PS.run_ranks(specs, ["cpu"] * world, str(d))
    return specs, single, out


def _metrics_close(got, want, rtol=1e-5):
    for g, w in zip(got["metrics"], want["metrics"], strict=True):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=1e-7,
                                       err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case,dropout", SPECS)
def test_ranks_match_the_single_process_step(runs, world, case, dropout):
    """With dropout and scheduled sampling on (and without, the runs that
    ``tests/test_torch_port_parallel_train_jax.py`` holds against JAX):
    the ranks' global losses, gradients, params and running statistics
    are the single-process step's, and every rank holds the same parameter
    bits."""
    specs, single, ranks = runs
    i = SPECS.index((case, dropout))
    reports = [r[i] for r in ranks[world]]
    ref = single[i]
    _metrics_close(reports[0], ref)
    assert PS.same_gradients(reports[0], ref) == []
    assert PS.same_parameters(reports[0], ref) == []
    assert len({r["checksum"] for r in reports}) == 1
    for r in reports:
        np.testing.assert_allclose(r["val_loss"], ref["val_loss"], rtol=1e-6)
    assert reports[0]["backend"] == "gloo"
    assert all(r["startup_s"] > 0 for r in reports)


@pytest.mark.parametrize("world", WORLDS)
def test_scst_step_scores_the_global_batch(runs, world):
    """One SCST step after the train steps: the ranks' loss and mean
    reward are the single-process step's (CIDEr over the whole batch)."""
    specs, single, ranks = runs
    i = SPECS.index(("sub_gc", True))
    reports = [r[i] for r in ranks[world]]
    np.testing.assert_allclose(reports[0]["scst"], single[i]["scst"],
                               rtol=1e-5)
    assert all(r["scst"] == reports[0]["scst"] for r in reports)


def test_a_failing_rank_fails_the_spawner(tmp_path):
    """A rank that raises makes ``run_ranks`` raise; nothing falls back."""
    bad = _spec("sub_gc", False)
    bad["batches"] = [train_batch(ModelConfig(**WIDTHS), 1)._replace(
        labels=None)]
    with pytest.raises(Exception, match="rank|Process|terminated"):
        PS.run_ranks([bad], ["cpu"] * 2, str(tmp_path))
