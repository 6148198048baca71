"""The port's evaluation CLIs against the JAX package's on the same files.

* ``cli/test.py --language_eval 1`` on one checkpoint (the port's numpy
  ``init_params_numpy`` weights written by the JAX ``save_checkpoint``)
  writes an ``all_scores_<tag>_<k>-subgraph.npy`` equal to the JAX CLI's,
  at ``--oracle_num`` 1 and 2;
* ``--only_sent_eval 1`` re-scores the saved captions without decoding
  (and without a card), equal to the JAX CLI's, also from
  ``--annotations_json``;
* ``--verbose_loss 1`` reports the split's LM loss within atol 1e-5 of
  the JAX CLI's (both loaders on their default, the C++ sampler);
* ``cli/{diversity,rerank,controllability}.py`` give the JAX CLIs'
  outputs (both packages on their C++ scorer cores); the rerank CLI runs with ``--device cpu`` and writes an equal
  ``consensus_rerank_ind.npy``.
"""
import json
import os
import pickle

import numpy as np
import pytest
import torch

import subgc_tpu.config as JC
import subgc_tpu.ops.native as JN
import subgc_tpu.train.step as JSTEP
import subgc_tpu_torch.train.step as PSTEP
from subgc_tpu.cli import controllability as j_ctl
from subgc_tpu.cli import diversity as j_div
from subgc_tpu.cli import rerank as j_rr
from subgc_tpu.cli import test as j_cli
from subgc_tpu.data.synthetic import generate_dataset
from subgc_tpu.train.checkpoint import save_checkpoint
from subgc_tpu_torch.cli import controllability as p_ctl
from subgc_tpu_torch.cli import diversity as p_div
from subgc_tpu_torch.cli import rerank as p_rr
from subgc_tpu_torch.cli import test as p_cli
from subgc_tpu_torch.config import ModelConfig
from subgc_tpu_torch.eval import runner as p_runner
from subgc_tpu_torch.models.params import init_params_numpy

from ._native_lib import wait_for_native
from .test_torch_port_metrics import (_ctl_inputs, _fanout_predictions,
                                      _int_feats, _sentences)
from .test_torch_port_scorers import assert_same

DIMS = dict(rnn_size=48, input_encoding_size=32, att_hid_size=24,
            gcn_dim=32, fc_feat_size=48, att_feat_size=64, embed_dim=16)


def write_checkpoint(ckpt, man, seed=4):
    """A Sub_GC_Kar checkpoint in the JAX format at tiny widths."""
    cfg = ModelConfig(vocab_size=man["vocab_size"],
                      num_obj_classes=man["n_obj_classes"],
                      num_rel_classes=man["n_rel_classes"], **DIMS)
    params, state = init_params_numpy(cfg, seed=seed)
    jcfg = JC.ModelConfig(**{f: getattr(cfg, f) for f in
                             ("vocab_size", "num_obj_classes",
                              "num_rel_classes", *DIMS)})
    save_checkpoint(ckpt, params, state, None,
                    {"iter": 2, "model_type": "Sub_GC_Kar",
                     "model_config": JC.config_to_json(jcfg)}, {})


def data_flags(man):
    return ["--input_json", man["input_json"],
            "--input_label_h5", man["input_label_h5"],
            "--sg_dir", man["sg_dir"], "--mask_dir", man["mask_dir"]]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_eval_cli")
    man = generate_dataset(str(root / "d"), n_images=10, vocab_size=40,
                           feat_dim=64, n_subgraphs=6, seed=37)
    ckpt = str(root / "ckpt")
    write_checkpoint(ckpt, man)
    common = ["Sub_GC_Kar", "--checkpoint_path", ckpt, "--bucket", "8",
              "--batch_images", "2", "--gpn_max_subg", "3"] \
        + data_flags(man)
    return root, ckpt, common


def _scores(ckpt, tag, k):
    path = os.path.join(ckpt, f"all_scores_{tag}_{k}-subgraph.npy")
    return np.load(path, allow_pickle=True).item()


@pytest.fixture(scope="module")
def decoded(run):
    """Both CLIs decode and score at --oracle_num 2 (tags j / p)."""
    _, ckpt, common = run
    flags = ["--language_eval", "1", "--oracle_num", "2"]
    j = j_cli.main(common + flags + ["--iter_tag", "j"])
    p = p_cli.main(common + flags + ["--iter_tag", "p", "--device", "cpu"])
    return j, p


def test_language_eval_scores_equal_jax(run, decoded):
    _, ckpt, _ = run
    j, p = decoded
    jp = np.load(j["captions_path"], allow_pickle=True).tolist()
    pp = np.load(p["captions_path"], allow_pickle=True).tolist()
    assert [a["caption"] for a in pp] == [b["caption"] for b in jp]
    assert_same(_scores(ckpt, "p", 2), _scores(ckpt, "j", 2))
    assert_same(p["scores"], _scores(ckpt, "p", 2))
    assert "oracle" in p["scores"] and len(p["scores"]["image_id_list"]) == 2
    for m in ("Bleu_4", "METEOR", "ROUGE_L", "CIDEr", "SPICE"):
        assert p["scores"][m].shape == (2, 2)


@pytest.mark.parametrize("oracle_num,annotations", [(1, False), (3, False),
                                                    (2, True)])
def test_only_sent_eval_rescores_without_decoding(run, decoded, monkeypatch,
                                                  oracle_num, annotations):
    root, ckpt, common = run
    flags = ["--only_sent_eval", "1", "--oracle_num", str(oracle_num)]
    if annotations:
        ids = [x["image_id"] for x in np.load(
            os.path.join(ckpt, "captions_j.npy"), allow_pickle=True)]
        gts = {str(i): _sentences(3, i) for i in ids}
        path = str(root / "annotations.json")
        with open(path, "w") as f:
            json.dump(gts, f)
        flags += ["--annotations_json", path]
    j = j_cli.main(common + flags + ["--iter_tag", "j"])

    def no_decode(*a, **kw):
        raise AssertionError("--only_sent_eval decoded")
    monkeypatch.setattr(p_runner, "run_test_split", no_decode)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = p_cli.main(common + flags + ["--iter_tag", "p"])
    assert p["captions_path"].endswith("captions_p.npy")
    assert_same(_scores(ckpt, "p", oracle_num), _scores(ckpt, "j",
                                                         oracle_num))
    assert_same(p["scores"], j["scores"])


def test_language_eval_top1_and_verbose_loss_equal_jax(run, monkeypatch,
                                                       capsys):
    """The test.sh command (--language_eval 1 at oracle 1) with the LM loss
    report: both loaders on the C++ sampler; both CLIs' val-step losses
    recorded at full precision.  The JAX package builds its C++ library
    in place on first use; a test process that loaded it while another was
    still writing it samples with its Python fallback for good (other
    draws, a loss 5.8e-4 away), so wait for a whole library first."""
    wait_for_native(JN)
    _, ckpt, common = run
    seen = {"j": [], "p": []}

    def recording(module, name):
        make = module.make_val_step

        def make_recording(cfg):
            step = make(cfg)

            def val_step(*a):
                out = step(*a)
                seen[name].append(float(out))
                return out
            return val_step
        monkeypatch.setattr(module, "make_val_step", make_recording)
    recording(JSTEP, "j")
    recording(PSTEP, "p")
    flags = ["--language_eval", "1", "--verbose_loss", "1"]
    j_cli.main(common + flags + ["--iter_tag", "jl"])
    j_line = [ln for ln in capsys.readouterr().out.splitlines()
              if "LM loss" in ln]
    p = p_cli.main(common + flags + ["--iter_tag", "pl", "--device", "cpu"])
    p_line = [ln for ln in capsys.readouterr().out.splitlines()
              if "LM loss" in ln]
    assert len(j_line) == len(p_line) == 1
    assert len(seen["p"]) == len(seen["j"]) >= 1
    assert p_line[0].split("(")[1] == j_line[0].split("(")[1]   # batches
    np.testing.assert_allclose(seen["p"], seen["j"], rtol=0, atol=1e-5)
    loss = float(np.mean(seen["p"]))
    assert np.isfinite(loss) and loss > 0
    assert p_line[0] == f"test LM loss: {loss:.4f} ({len(seen['p'])} batches)"
    assert_same(_scores(ckpt, "pl", 1), _scores(ckpt, "jl", 1))
    assert "oracle" not in p["scores"]


# ------------------------------------------------------- metric CLIs

def _save(path, obj):
    np.save(path, np.asarray(obj, dtype=object), allow_pickle=True)
    return path


def test_diversity_cli_equals_jax(tmp_path):
    caps = _save(str(tmp_path / "captions_x.npy"), _fanout_predictions())
    train = str(tmp_path / "train.json")
    with open(train, "w") as f:
        json.dump({"1": _sentences(40, 3), "2": _sentences(40, 4)}, f)
    argv = ["--input_file", caps, "--evaluate_mB4",
            "--train_sentences", train]
    assert_same(p_div.main(argv), j_div.main(argv))


def test_rerank_cli_equals_jax(tmp_path):
    preds = _fanout_predictions(n_images=5, seed=1)
    annos = [{"id": 900 + i, "sentences": _sentences(3, 50 + i)}
             for i in range(30)]
    te, tr = _int_feats(len(preds), len(annos), 8, seed=1)
    annos_path = str(tmp_path / "annos.json")
    with open(annos_path, "w") as f:
        json.dump(annos, f)
    feats = str(tmp_path / "feats.npz")
    np.savez(feats, train=tr, test=te)
    gts = str(tmp_path / "gts.json")
    with open(gts, "w") as f:
        json.dump({str(p["image_id"]): _sentences(3, 70 + p["image_id"])
                   for p in preds}, f)
    out = {}
    for name, cli, more in (("j", j_rr, []), ("p", p_rr,
                                              ["--device", "cpu"])):
        os.makedirs(tmp_path / name)
        caps = _save(str(tmp_path / name / "captions_x.npy"), preds)
        out[name] = cli.main(["--input_file", caps, "--train_annos",
                              annos_path, "--feats", feats, "--gts", gts,
                              "--top_k", "3", "--k", "6", "--m", "10",
                              "--num_NN", "20"] + more)
    p, j = out["p"], out["j"]
    assert p["rerank_ind_path"] == str(tmp_path / "p" /
                                       "consensus_rerank_ind.npy")
    assert_same(np.load(p["rerank_ind_path"], allow_pickle=True).item(),
                np.load(j["rerank_ind_path"], allow_pickle=True).item())
    assert_same(p["scores"], j["scores"])


def test_rerank_cli_runs_on_the_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    te, tr = _int_feats(2, 6, 3, seed=0)
    feats = str(tmp_path / "feats.npz")
    np.savez(feats, train=tr, test=te)
    annos = _save(str(tmp_path / "annos.npy"),
                  [{"id": i, "sentences": ["a dog"]} for i in range(6)])
    caps = _save(str(tmp_path / "captions_x.npy"),
                 _fanout_predictions(n_images=2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        p_rr.main(["--input_file", caps, "--train_annos", annos,
                   "--feats", feats])


@pytest.mark.parametrize("glove", ["npz", "pkl"])
def test_controllability_cli_equals_jax(tmp_path, glove):
    preds, order, gts, nouns = _ctl_inputs(seed=2)
    argv = ["--input_file", _save(str(tmp_path / "ctl.npy"), preds),
            "--order_list", _save(str(tmp_path / "order.npy"), order),
            "--gt_captions", _save(str(tmp_path / "gts.npy"), gts)]
    if glove == "npz":
        path = str(tmp_path / "nouns.npz")
        np.savez(path, words=np.asarray(list(nouns), dtype=object),
                 vecs=np.stack(list(nouns.values())))
    else:
        path = str(tmp_path / "nouns.pkl")
        with open(path, "wb") as f:
            pickle.dump(nouns, f)
    argv += ["--noun_glove", path]
    out = p_ctl.main(argv)
    assert_same(out, j_ctl.main(argv))
    assert "NounIoU" in out and "SPICE" in out
