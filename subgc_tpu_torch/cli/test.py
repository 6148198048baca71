"""Inference CLI — `python -m subgc_tpu_torch.cli.test <MODEL_TYPE> [flags]`.

The port's counterpart of ``subgc_tpu/cli/test.py``, with the same flags
plus ``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path):
decode the test split with the preset's beam / NMS / sampling settings and
write ``captions_<tag>.npy`` (``ctl_captions_<tag>.npy`` for the SCT
presets), ``grounding_file.json`` with ``--return_att 1`` and
``vis/vis.json`` with ``--dump_json 1``.  Configs resolve in the order
preset, then the checkpoint's ``infos.json``, then flags; the weights load
from the checkpoint's ``model.npz``, and a checkpoint trained in bf16
(``compute_dtype`` in its ``model_config``) decodes in bf16, as the JAX
CLI's does.  ``--language_eval 1`` scores the
captions against the split's GT (``--annotations_json``, else the label
h5) and writes ``all_scores_<tag>_<oracle_num>-subgraph.npy``;
``--only_sent_eval 1`` re-scores a saved ``captions_<tag>.npy`` without
decoding; ``--verbose_loss 1`` also prints the split's teacher-forced LM
loss.

``--group_size G`` decodes in G diverse beam groups of ``beam_size / G``
beams each (``--diversity_lambda``); ``--packed_path`` reads packed shards
(a path, a glob or a comma list) in place of ``--sg_dir`` / ``--mask_dir``.

``--n_devices N`` decodes over N cards (``cuda:0..N-1``) from one
process, one thread per card: each card takes ``batch_images / N`` images
of every dispatch, or with ``--shard_subgraphs`` a contiguous share of the
dispatch's flat sub-graph rows (a single keep-1000 image spreads over the
cards); the captions are the one-card run's.  It is slower than one card
on every path measured (the threads of a host-bound decode share one
interpreter lock; ``PERF.md``) until a process per card decodes its shard.
On ``--device cpu`` the N entries are all the CPU.  Full_GC_Kar has no
batched route (nor in the JAX CLI), so ``run_test_split`` refuses it:
decode it with ``models.subgc.encode_image`` + ``beam_search``.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..device import f32_accumulation


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("model_type", nargs="?", default="Sub_GC_Kar")
    p.add_argument("--checkpoint_path", type=str, required=True,
                   help="directory with model.npz + infos.json")
    p.add_argument("--iter_tag", type=str, default=None,
                   help="tag for captions_<tag>.npy (default: ckpt iter)")
    p.add_argument("--num_images", type=int, default=-1)
    p.add_argument("--batch_images", type=int, default=16)
    p.add_argument("--n_devices", type=int, default=None,
                   help="decode over N cards (cuda:0..N-1) from one "
                        "process, one thread per card: slower than one "
                        "card until a process per card lands")
    p.add_argument("--shard_subgraphs", action="store_true",
                   help="with --n_devices > 1: shard the flat sub-graph "
                        "rows over the cards instead of the images")
    p.add_argument("--bucket", type=int, default=None,
                   help="static sub-graph bucket (default: preset)")
    p.add_argument("--beam_size", type=int, default=None)
    p.add_argument("--gpn_nms_thres", type=float, default=None)
    p.add_argument("--gpn_max_subg", type=int, default=None)
    p.add_argument("--language_eval", type=int, default=0)
    p.add_argument("--only_sent_eval", type=int, default=0)
    p.add_argument("--oracle_num", type=int, default=1)
    p.add_argument("--return_att", type=int, default=None)
    p.add_argument("--use_topk_sampling", type=int, default=None)
    p.add_argument("--topk_temp", type=float, default=None)
    p.add_argument("--the_k", type=int, default=None)
    p.add_argument("--group_size", type=int, default=None,
                   help="diverse beam groups (beam_size must divide by it)")
    p.add_argument("--diversity_lambda", type=float, default=None)
    p.add_argument("--decoding_constraint", type=int, default=None)
    p.add_argument("--length_penalty", type=str, default=None)
    p.add_argument("--remove_bad_endings", type=int, default=None)
    p.add_argument("--input_json", type=str, default=None)
    p.add_argument("--input_label_h5", type=str, default=None)
    p.add_argument("--sg_dir", type=str, default=None)
    p.add_argument("--mask_dir", type=str, default=None)
    p.add_argument("--packed_path", type=str, default=None,
                   help="packed shard(s) (glob / comma-list) replacing "
                        "--sg_dir/--mask_dir")
    p.add_argument("--annotations_json", type=str, default=None,
                   help="GT annotation json for language eval "
                        "({image_id: [captions]}); defaults to the "
                        "dataset's own label h5")
    p.add_argument("--sct_dict", type=str,
                   default="data/sct_dict_test_grouped_gt_box.npy",
                   help="grouped GT region sets for SCT presets")
    p.add_argument("--img_wh", type=str, default="data/flickr30k_img_wh.npy",
                   help="{img_id: (w,h)} table for SCT/grounding presets")
    p.add_argument("--split", type=str, default="test")
    p.add_argument("--seed", type=int, default=2019)
    p.add_argument("--verbose_beam", type=int, default=None,
                   help="print every beam of one random kept sub-graph "
                        "per image (reference default 1; here 0)")
    p.add_argument("--verbose_loss", type=int, default=0,
                   help="also report the teacher-forced LM loss over the "
                        "split's labels (eval_utils.py:73-86)")
    p.add_argument("--dump_json", type=int, default=0,
                   help="write vis/vis.json with the best caption per "
                        "image")
    p.add_argument("--dump_path", type=int, default=0,
                   help="include each image's file_path in vis/vis.json")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def _mesh(args):
    """The ``--n_devices`` mesh, or None, with the JAX CLI's checks and
    messages (``subgc_tpu/cli/test.py``)."""
    import torch

    from ..parallel.mesh import make_mesh
    many = args.n_devices is not None and args.n_devices > 1
    if args.shard_subgraphs and not many:
        raise SystemExit("--shard_subgraphs requires --n_devices > 1 "
                         "(it picks WHICH axis shards over the mesh)")
    if not many:
        return None
    on_card = torch.device(args.device).type == "cuda"
    if on_card:
        avail = torch.cuda.device_count()
        if args.n_devices > avail:
            raise SystemExit(f"--n_devices {args.n_devices} > {avail} "
                             f"attached devices")
    if not args.shard_subgraphs and args.batch_images % args.n_devices:
        raise SystemExit(f"--batch_images {args.batch_images} must "
                         f"be divisible by --n_devices "
                         f"{args.n_devices} (or use "
                         f"--shard_subgraphs)")
    if on_card:
        return make_mesh(n_data=args.n_devices)
    return make_mesh(devices=[args.device] * args.n_devices)


def _load_npy_dict(path):
    return np.load(path, allow_pickle=True, encoding="latin1").tolist()


def _gts_from_loader(loader, split):
    """Decode the label h5 GT captions to strings per image id."""
    from ..utils.text import decode_sequence
    gts = {}
    for ix in loader.split_ix[split]:
        gts[loader.ds.images[ix]["id"]] = decode_sequence(
            loader.vocab, loader.ds.captions_for(ix),
            remove_bad_endings=False)
    return gts


def _lm_loss(params, state, mcfg, dcfg, args, dev):
    """The split's teacher-forced LM loss, the JAX CLI's batching: batches
    of min(8, batch_images) images until the split wraps."""
    from ..config import TrainConfig
    from ..data.dataset import TrainLoader
    from ..train.step import batch_to_device, make_val_step
    tloader = TrainLoader(mcfg, TrainConfig(
        batch_size=min(8, max(1, args.batch_images))), dcfg, seed=args.seed)
    val_step = make_val_step(mcfg)
    n_img = len(tloader.split_ix[args.split]) \
        if args.num_images < 0 else args.num_images
    tot, nb = 0.0, 0
    tloader.reset_iterator(args.split)
    for _ in range(max(1, n_img // tloader.batch_size)):
        vb, _, vw = tloader.get_batch(args.split)
        tot += float(val_step(params, state, batch_to_device(vb, dev)))
        nb += 1
        if vw:
            break
    return tot / nb, nb


def _decode(args, mcfg, ecfg, dcfg, loader, dev, iter_tag, mesh=None):
    """Decode the split and save its captions file; write the grounding /
    vis artifacts and print the LM loss where the flags ask for them.
    Returns (captions path, predictions)."""
    from ..eval.runner import run_test_split, save_predictions
    from ..models.params import load_model_npz, params_from_numpy

    blob = load_model_npz(os.path.join(args.checkpoint_path, "model.npz"))
    params = params_from_numpy(blob["params"], dev)
    state = params_from_numpy(blob["state"], dev)

    collector = None
    if ecfg.return_att and os.path.exists("data/gvd_all_dict.npy"):
        from ..eval.grounding import GroundingCollector
        gvd = _load_npy_dict("data/gvd_all_dict.npy")
        img_wh = _load_npy_dict("data/flickr30k_img_wh.npy") \
            if os.path.exists("data/flickr30k_img_wh.npy") else {}
        rr_path = os.path.join(args.checkpoint_path,
                               "consensus_rerank_ind.npy")
        rr = np.load(rr_path, allow_pickle=True).tolist() \
            if os.path.exists(rr_path) else None
        collector = GroundingCollector(
            gvd["wd_to_lemma"], gvd["lemma_det_id_dict"],
            gvd["det_id_to_det_wd"], img_wh, rerank_ind=rr)

    preds, wall, n_caps = run_test_split(
        params, state, loader, mcfg, ecfg, loader.vocab, split=args.split,
        num_images=args.num_images, batch_images=args.batch_images,
        device=dev, collect_grounding=collector, mesh=mesh,
        shard_axis="subgraph" if args.shard_subgraphs else "image")
    path = save_predictions(preds, args.checkpoint_path, iter_tag,
                            sct=ecfg.sct)
    print(f"decoded {n_caps} captions for {len(preds)} images in "
          f"{wall:.1f}s on {list(mesh.devices) if mesh else dev} -> {path}")
    if collector is not None:
        gpath = os.path.join(args.checkpoint_path, "grounding_file.json")
        collector.save(gpath)
        print(f"grounding material -> {gpath}")

    if args.verbose_loss:
        # teacher-forced LM loss over the split's labels — the
        # reference's in-eval loss report (eval_utils.py:73-86)
        lm_loss, nb = _lm_loss(params, state, mcfg, dcfg, args, dev)
        print(f"{args.split} LM loss: {lm_loss:.4f} ({nb} batches)")

    if args.dump_json:
        # vis/vis.json: best caption per image (+ file_path with
        # --dump_path), the reference's test.py:48-50 artifact
        id_to_path = {img["id"]: img.get("file_path", "")
                      for img in loader.ds.images}
        vis = []
        for pr in preds:
            entry = {"image_id": pr["image_id"],
                     "caption": pr["caption"][0] if pr["caption"] else ""}
            if args.dump_path:
                entry["file_path"] = id_to_path.get(pr["image_id"], "")
            vis.append(entry)
        os.makedirs("vis", exist_ok=True)
        with open(os.path.join("vis", "vis.json"), "w") as f:
            json.dump(vis, f)
        print(f"predictions -> vis/vis.json ({len(vis)} images)")
    return path, preds


@f32_accumulation()          # bf16 matmuls sum in float32, as in JAX
def main(argv=None):
    args = parse_args(argv)

    from ..config import ModelConfig, build_configs, config_from_json
    from ..data.dataset import EvalLoader
    from ..device import resolve_device
    from ..eval.sentence import align_predictions, language_eval

    # preset < checkpoint infos < CLI flags
    mcfg, ecfg, dcfg = build_configs(args.model_type, mode="test")
    infos_path = os.path.join(args.checkpoint_path, "infos.json")
    infos = {}
    if os.path.exists(infos_path):
        with open(infos_path) as f:
            infos = json.load(f)
        mcfg = config_from_json(ModelConfig, infos["model_config"])
        if infos.get("model_type") and infos["model_type"] != args.model_type:
            print(f"note: checkpoint was trained as {infos['model_type']}, "
                  f"evaluating as {args.model_type}")
    for k in ["beam_size", "gpn_nms_thres", "gpn_max_subg", "return_att",
              "use_topk_sampling", "oracle_num", "only_sent_eval",
              "topk_temp", "the_k", "group_size", "diversity_lambda",
              "decoding_constraint", "length_penalty",
              "remove_bad_endings", "verbose_beam"]:
        v = getattr(args, k)
        if v is not None:
            ecfg = ecfg.replace(**{k: bool(v) if k in ("return_att",
                                                       "use_topk_sampling",
                                                       "remove_bad_endings")
                                   else v})
    if ecfg.group_size > 1 and ecfg.beam_size % ecfg.group_size != 0:
        raise SystemExit(
            f"--beam_size {ecfg.beam_size} must be divisible by "
            f"--group_size {ecfg.group_size} (each diverse group runs "
            f"beam_size/group_size beams)")
    for k in ["input_json", "input_label_h5", "sg_dir", "mask_dir",
              "packed_path"]:
        if getattr(args, k) is not None:
            dcfg = dcfg.replace(**{k: getattr(args, k)})
    # re-scoring a saved captions file runs nothing on a device
    dev = None if ecfg.only_sent_eval else resolve_device(args.device)
    mesh = None if ecfg.only_sent_eval else _mesh(args)

    bucket = args.bucket or ecfg.max_subgraph_bucket
    if ecfg.sct:
        from ..data.sct import SCTLoader
        loader = SCTLoader(mcfg, dcfg, _load_npy_dict(args.sct_dict),
                           _load_npy_dict(args.img_wh),
                           use_greedy_subg=ecfg.use_greedy_subg,
                           use_gt_subg=ecfg.use_gt_subg, bucket=bucket,
                           seed=args.seed)
    else:
        loader = EvalLoader(mcfg, dcfg, bucket=bucket, seed=args.seed)
    mcfg = mcfg.replace(vocab_size=loader.vocab_size,
                        seq_length=loader.seq_length)
    iter_tag = args.iter_tag or str(infos.get("iter", "0"))

    if not ecfg.only_sent_eval:
        path, preds = _decode(args, mcfg, ecfg, dcfg, loader, dev, iter_tag,
                              mesh)
    else:
        path = os.path.join(args.checkpoint_path,
                            f"captions_{iter_tag}.npy")
        preds = np.load(path, allow_pickle=True).tolist()
        print(f"loaded {len(preds)} predictions from {path}")

    scores = None
    if args.language_eval or ecfg.only_sent_eval:
        if args.annotations_json:
            with open(args.annotations_json) as f:
                gts = {int(k): v for k, v in json.load(f).items()}
        else:
            gts = _gts_from_loader(loader, args.split)
        aligned = align_predictions(preds, ecfg.oracle_num)
        scores = language_eval(
            gts, aligned,
            cache_dir=os.path.join(args.checkpoint_path, "eval_results"),
            model_id=args.model_type, split=args.split)
        out = os.path.join(args.checkpoint_path,
                           f"all_scores_{iter_tag}_{ecfg.oracle_num}"
                           f"-subgraph.npy")
        np.save(out, np.asarray(scores, dtype=object), allow_pickle=True)
        print(f"scores -> {out}")
    return {"captions_path": path, "scores": scores, "iter_tag": iter_tag}


if __name__ == "__main__":
    main()
