"""The port's paper-table orchestrator (``cli/reproduce.py --device cpu``)
against the JAX package's on one manifest with one model of each family:
Sub_GC_Kar (language eval + consensus rerank), Sub_GC_MRNN (language eval
+ diversity), Sub_GC_Flickr_CTL (controllability) and Sub_GC_Flickr_GRD
(grounding, then the rerank-aware second pass).  Every stage's result in
``reproduce_summary.json`` is equal, apart from the captions paths, which
name each run's own checkpoint copy; both packages score with their C++
cores.
"""
import json
import os
import shutil

import numpy as np
import pytest

from subgc_tpu.cli import reproduce as j_repro
from subgc_tpu.cli import test as j_cli
from subgc_tpu.data.synthetic import generate_dataset
from subgc_tpu.io.sg_npz import SGDir
from subgc_tpu_torch.cli import reproduce as p_repro

from .test_torch_port_eval_cli import data_flags, write_checkpoint
from .test_torch_port_scorers import assert_same


def _dump(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f)
    return path


@pytest.fixture(scope="module")
def manifests(tmp_path_factory):
    """A checkpoint copy, output directory and manifest per package, over
    shared rerank, controllability and grounding inputs; the grounding
    tables under ``data/`` of the directory returned (the test CLIs read
    them from there)."""
    root = tmp_path_factory.mktemp("port_repro")
    man = generate_dataset(str(root / "d"), n_images=10, vocab_size=40,
                           feat_dim=64, n_subgraphs=6, seed=11)
    write_checkpoint(str(root / "ckpt_j"), man, seed=5)
    shutil.copytree(root / "ckpt_j", root / "ckpt_p")
    with open(man["input_json"]) as f:
        info = json.load(f)
    images, words = info["images"], list(info["ix_to_word"].values())
    test_ids = [img["id"] for img in images if img["split"] == "test"]
    rng = np.random.RandomState(3)

    def sent(n):
        return " ".join(words[rng.randint(len(words))] for _ in range(n))

    annos = [{"id": 5000 + i, "sentences": [sent(5) for _ in range(3)]}
             for i in range(8)]
    np.savez(root / "feats.npz",
             train=rng.randint(-4, 5, (8, 16)).astype("f"),
             test=rng.randint(-4, 5, (len(test_ids), 16)).astype("f"))
    sg = SGDir(man["sg_dir"])
    sct, wh = {}, {}
    for i in test_ids:
        boxes = np.asarray(sg.get(i)["boxes"])
        wh[i] = (592, 592)
        rs = np.zeros((2, 2, 5))
        for g in range(2):
            rs[g, 0, :4] = boxes[rng.randint(boxes.shape[0])]
            rs[g, 0, 4] = 1
        sct[str(i)] = rs
    np.save(root / "sct.npy", sct)
    np.save(root / "wh.npy", wh)
    np.save(root / "order.npy", np.asarray(test_ids, dtype=object))
    np.save(root / "gt_groups.npy",
            np.asarray([[sent(4)] for _ in range(2 * len(test_ids))],
                       dtype=object))
    np.savez(root / "nglove.npz", words=np.asarray(words, dtype=object),
             vecs=rng.rand(len(words), 16))
    os.makedirs(root / "data")
    lemma_det = {w: i for i, w in enumerate(words)}
    np.save(root / "data" / "gvd_all_dict.npy",
            {"wd_to_lemma": {w: w for w in words},
             "lemma_det_id_dict": lemma_det,
             "det_id_to_det_wd": {i: w for w, i in lemma_det.items()}})
    np.save(root / "data" / "flickr30k_img_wh.npy", wh)
    np.save(root / "data" / "MRNN_split_dict.npy",
            {img["id"]: img["split"] for img in images})

    grd_flags = ["--bucket", "8", "--batch_images", "2", "--gpn_max_subg",
                 "3"]
    # a grounding reference whose classes the collector emits (a JAX
    # pre-pass, as tests/test_reproduce.py fabricates it)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        j_cli.main(["Sub_GC_Flickr_GRD", "--checkpoint_path",
                    str(root / "ckpt_j"), "--iter_tag", "pre"] + grd_flags
                   + data_flags(man))
    finally:
        os.chdir(cwd)
    with open(root / "ckpt_j" / "grounding_file.json") as f:
        results = json.load(f)["results"]
    ref = []
    for img_id, entries in results.items():
        e = entries[0]
        if e["clss"]:
            ref.append({"image_id": int(img_id), "captions": [{
                "process_bnd_box": [[e["bbox"][0]]],
                "process_idx": [e["idx_in_sent"][0]],
                "process_clss": [e["clss"][0]],
                "tokens": ["a"] * (e["idx_in_sent"][0] + 1)}]})
    assert ref, "the pre-pass grounded no word"

    out = {}
    for name in ("j", "p"):
        ckpt = str(root / f"ckpt_{name}")
        out[name] = _dump(str(root / f"manifest_{name}.json"), {
            "data": {k: man[k] for k in ("input_json", "input_label_h5",
                                         "sg_dir", "mask_dir")},
            "output": str(root / f"out_{name}"),
            "models": {
                "Sub_GC_Kar": {"checkpoint_path": ckpt, "oracle_num": 2,
                               "test_flags": grd_flags + ["--beam_size",
                                                          "2"]},
                "Sub_GC_MRNN": {"checkpoint_path": ckpt,
                                "test_flags": ["--bucket", "8",
                                               "--gpn_max_subg", "4",
                                               "--batch_images", "2"]},
                "Sub_GC_Flickr_CTL": {"checkpoint_path": ckpt,
                                      "test_flags": ["--bucket", "8",
                                                     "--batch_images", "2"]},
                "Sub_GC_Flickr_GRD": {"checkpoint_path": ckpt,
                                      "test_flags": grd_flags}},
            "rerank": {"train_annos": _dump(str(root / "annos.json"), annos),
                       "feats": str(root / "feats.npz"), "top_k": 2,
                       "gts": _dump(str(root / "gts.json"),
                                    {str(i): [sent(5), sent(6)]
                                     for i in test_ids})},
            "diversity": {},
            "grounding": {"reference": _dump(str(root / "grd_ref.json"),
                                             ref)},
            "controllability": {
                "sct_dict": str(root / "sct.npy"),
                "img_wh": str(root / "wh.npy"),
                "order_list": str(root / "order.npy"),
                "gt_captions": str(root / "gt_groups.npy"),
                "noun_glove": str(root / "nglove.npz")}})
    return root, out


def test_reproduce_summary_equals_jax(manifests, monkeypatch):
    root, man = manifests
    monkeypatch.chdir(root)
    j = j_repro.main(["--manifest", man["j"]])
    p = p_repro.main(["--manifest", man["p"], "--device", "cpu"])
    with open(root / "out_p" / "reproduce_summary.json") as f:
        assert json.load(f).keys() == p.keys()
    assert (root / "out_p" / "reproduce_summary.md").exists()
    for model in j:
        for stage in j[model]:
            assert not str(j[model][stage]).startswith(("FAILED",
                                                         "skipped")), \
                (model, stage, j[model][stage])
        jt, pt = j[model].pop("test"), p[model].pop("test")
        assert os.path.basename(jt["captions_path"]) == \
            os.path.basename(pt["captions_path"])
    assert_same(p, j)
    assert set(p["Sub_GC_Kar"]) == {"language_eval", "rerank"}
    assert "mBLEU4" in p["Sub_GC_MRNN"]["diversity"]
    assert "NounIoU" in p["Sub_GC_Flickr_CTL"]["controllability"]
    assert "precision_all" in p["Sub_GC_Flickr_GRD"]["grounding_rerank"]
    assert os.path.exists(root / "ckpt_p" / "consensus_rerank_ind.npy")
