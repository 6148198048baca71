"""Pack an npz-directory dataset into a fixed-record binary shard — the
port's counterpart of ``tools/pack_dataset.py``, with the same flags; the
shard is byte for byte the JAX tool's (``data/packed.py``), and the
``--packed_path`` readers of both packages' CLIs read it.

    python -m subgc_tpu_torch.cli.pack --input_json data/cocotalk.json \\
        --sg_dir data/COCO_sg_output_64 \\
        --mask_dir data/COCO_graph_mask_1000_rm_duplicate \\
        --out data/coco_packed.bin [--max_subg 1000]

Runs on the host alone (numpy; no card, no h5py).
"""
from __future__ import annotations

import argparse
import json
import os


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--input_json", required=True)
    ap.add_argument("--sg_dir", required=True)
    ap.add_argument("--mask_dir", default=None)
    ap.add_argument("--out", required=True)
    ap.add_argument("--max_subg", type=int, default=1000)
    ap.add_argument("--feat_dim", type=int, default=2048)
    ap.add_argument("--n_obj_cls", type=int, default=1599)
    ap.add_argument("--n_rel_cls", type=int, default=21)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from ..data.packed import PackedSpec, pack_image, write_shard
    from ..io.sg_npz import SGDir

    spec = PackedSpec(feat_dim=args.feat_dim, n_obj_cls=args.n_obj_cls,
                      n_rel_cls=args.n_rel_cls, max_subg=args.max_subg)
    with open(args.input_json) as f:
        images = json.load(f)["images"]
    sg = SGDir(args.sg_dir)
    masks = SGDir(args.mask_dir) if args.mask_dir else None

    records = []
    for i, img in enumerate(images):
        sg_d = sg.get(img["id"])
        mask_d = masks.get(img["id"]) if masks else None
        records.append(pack_image(spec, img["id"], sg_d, mask_d))
        if (i + 1) % 500 == 0:
            print(f"packed {i + 1}/{len(images)}")
    write_shard(args.out, spec, records)
    sz = os.path.getsize(args.out) / 1e9
    print(f"wrote {args.out}: {len(records)} images, {sz:.2f} GB "
          f"({spec.record_size / 1e6:.2f} MB/record)")
    return args.out


if __name__ == "__main__":
    main()
