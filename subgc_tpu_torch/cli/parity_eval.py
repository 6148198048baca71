"""Caption parity against a reference run — the port's counterpart of
``tools/parity_eval.py``, with the same flags plus ``--device`` (default
``cuda``; ``cpu`` runs the plain PyTorch path).

It converts the reference's ``model-<iter>.pth`` in memory
(``cli/convert_ckpt.py``), decodes the test split with the port's
``EvalLoader`` + ``run_test_split``, and with ``--ref_captions`` compares
the ``captions_*.npy`` the reference's own ``test.py`` wrote, caption by
caption:

    python -m subgc_tpu_torch.cli.parity_eval \\
        --ckpt pretrained/sub_gc_karpathy/model-60000.pth \\
        --ref_captions pretrained/sub_gc_karpathy/captions_60000.npy \\
        --input_json data/cocotalk.json --input_label_h5 data/cocotalk_label.h5 \\
        --sg_dir data/COCO_sg_output_64 \\
        --mask_dir data/COCO_graph_mask_1000_rm_duplicate \\
        --beam_size 2 --gpn_nms_thres 0.75 --gpn_max_subg 10
"""
from __future__ import annotations

import argparse

import numpy as np

from ..device import f32_accumulation


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--ref_captions", default=None,
                    help="captions_*.npy produced by the reference")
    ap.add_argument("--input_json", required=True)
    ap.add_argument("--input_label_h5", required=True)
    ap.add_argument("--sg_dir", required=True)
    ap.add_argument("--mask_dir", required=True)
    ap.add_argument("--beam_size", type=int, default=2)
    ap.add_argument("--gpn_nms_thres", type=float, default=0.75)
    ap.add_argument("--gpn_max_subg", type=int, default=10)
    ap.add_argument("--bucket", type=int, default=1024)
    ap.add_argument("--num_images", type=int, default=-1)
    ap.add_argument("--full_gc", action="store_true")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def caption_match(preds, ref):
    """(matching captions, compared captions) of ``preds`` against the
    reference's prediction list, image by image, in ranked order."""
    ref_by_id = {int(r["image_id"]): r for r in ref}
    total = match = 0
    for p in preds:
        r = ref_by_id.get(int(p["image_id"]))
        if r is None:
            continue
        for a, b in zip(p["caption"], r["caption"]):
            total += 1
            match += int(a == b)
    return match, total


@f32_accumulation()
def main(argv=None):
    args = parse_args(argv)

    from ..config import DataConfig, EvalConfig
    from ..data.dataset import EvalLoader
    from ..device import resolve_device
    from ..eval.runner import run_test_split
    from ..models.params import params_from_numpy
    from .convert_ckpt import (legacy_config, load_state_dict,
                               torch_state_dict_to_params)

    dev = resolve_device(args.device)
    dcfg = DataConfig(input_json=args.input_json,
                      input_label_h5=args.input_label_h5,
                      sg_dir=args.sg_dir, mask_dir=args.mask_dir)
    mcfg = legacy_config(full_gc=args.full_gc)
    loader = EvalLoader(mcfg, dcfg, bucket=args.bucket)
    mcfg = mcfg.replace(vocab_size=loader.vocab_size,
                        seq_length=loader.seq_length)
    ecfg = EvalConfig(beam_size=args.beam_size,
                      gpn_nms_thres=args.gpn_nms_thres,
                      gpn_max_subg=args.gpn_max_subg)

    params, state = torch_state_dict_to_params(load_state_dict(args.ckpt),
                                               mcfg)
    preds, wall, n_caps = run_test_split(
        params_from_numpy(params, dev), params_from_numpy(state, dev),
        loader, mcfg, ecfg, loader.vocab, num_images=args.num_images,
        device=dev)
    print(f"decoded {n_caps} captions for {len(preds)} images in "
          f"{wall:.1f}s on {dev}")

    result = {"preds": preds, "match": None, "total": None}
    if args.ref_captions:
        ref = np.load(args.ref_captions, allow_pickle=True,
                      encoding="latin1").tolist()
        match, total = caption_match(preds, ref)
        print(f"caption match: {match}/{total} "
              f"({100.0 * match / max(total, 1):.2f}%)")
        result.update(match=match, total=total)
    return result


if __name__ == "__main__":
    main()
