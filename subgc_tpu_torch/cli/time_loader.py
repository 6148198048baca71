"""Time ``TrainLoader.get_batch`` on the host — `python -m
subgc_tpu_torch.cli.time_loader [--n_images 110] [--batches 3]`.

Writes a synthetic dataset at the presets' full widths (36 detections of
2048 features, 1599 object and 21 predicate classes, 64 relations, banks
of 5 + 1000 sub-graphs) and a packed shard of it into a temporary
directory, then times Sub_GC_Kar's ``get_batch`` (64 images) four ways:
npz or packed shard, each with the C++ or the Python sampler.  The loader
runs on the host CPU alone (it needs h5py for the label file), so every
figure is a host-CPU time; the report names the CPU.  Prints one JSON
object.
"""
from __future__ import annotations

import argparse
import json
import os
import platform
import statistics
import tempfile
import time


def _cpu_name() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or "unknown"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n_images", type=int, default=110,
                   help="images written (3 in 5 are train images)")
    p.add_argument("--n_subgraphs", type=int, default=1000)
    p.add_argument("--batches", type=int, default=3,
                   help="timed get_batch calls per configuration")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from ..config import DataConfig, build_configs
    from ..data import packed as P
    from ..data.dataset import TrainLoader
    from ..data.synthetic import generate_dataset
    from ..io.sg_npz import SGDir

    mcfg, tcfg, _ = build_configs("Sub_GC_Kar", mode="train")
    out = {"host_cpu": _cpu_name(), "cpu_count": os.cpu_count(),
           "batch_images": tcfg.batch_size, "n_subgraphs": args.n_subgraphs}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        man = generate_dataset(root, n_images=args.n_images,
                               vocab_size=mcfg.vocab_size,
                               n_obj_classes=mcfg.num_obj_classes,
                               n_rel_classes=mcfg.num_rel_classes,
                               n_subgraphs=args.n_subgraphs,
                               feat_dim=mcfg.att_feat_size, min_obj=36,
                               seed=args.seed)
        with open(man["input_json"]) as f:
            images = json.load(f)["images"]
        spec = P.PackedSpec(feat_dim=mcfg.att_feat_size,
                            n_obj_cls=mcfg.num_obj_classes,
                            n_rel_cls=mcfg.num_rel_classes,
                            max_subg=args.n_subgraphs)
        sg, masks = SGDir(man["sg_dir"]), SGDir(man["mask_dir"])
        shard = os.path.join(root, "shard.bin")
        P.write_shard(shard, spec, [
            P.pack_image(spec, im["id"], sg.get(im["id"]),
                         masks.get(im["id"])) for im in images])
        out["write_s"] = time.perf_counter() - t0
        base = dict(input_json=man["input_json"],
                    input_label_h5=man["input_label_h5"])
        sources = {"npz": DataConfig(sg_dir=man["sg_dir"],
                                     mask_dir=man["mask_dir"], **base),
                   "packed": DataConfig(packed_path=shard, **base)}
        for src, dcfg in sources.items():
            for sampler in ("cpp", "python"):
                loader = TrainLoader(mcfg, tcfg, dcfg, seed=args.seed,
                                     native_sampler=sampler == "cpp")
                loader.get_batch("train")         # page cache, first use
                times = []
                for _ in range(args.batches):
                    t1 = time.perf_counter()
                    loader.get_batch("train")
                    times.append(1e3 * (time.perf_counter() - t1))
                ms = statistics.median(times)
                out[f"{src}_{sampler}"] = {
                    "ms_per_batch": ms,
                    "ms_per_image": ms / tcfg.batch_size}
                print(f"get_batch {src:6s} + {sampler:6s} sampler: "
                      f"{ms:.1f} ms per {tcfg.batch_size}-image batch "
                      f"({ms / tcfg.batch_size:.3f} ms / image), host CPU")
    print(json.dumps({"loader": out}))
    return out


if __name__ == "__main__":
    main()
