"""The output check's control and planted faults, read at a cell's own size
on the card: the numbers that set each limit's upper end.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed it makes the cell's inputs and weights as a run does and
prints one JSON line of the numbers the check compares:

* ``control``: the reference in the program's place, computed with TF32
  (the nearest precision below the configuration's float32 with TF32 off);
* test cells, ``fault_token``: the reference's own captions with one token
  of each altered where it is produced; in a beam search also
  ``fault_greedy``, greedy captions in place of the beam's, and
  ``fault_second_beam``, the second best done beam served;
* training cells, ``fault_half_batch`` and ``fault_token``: the reference
  with the loss over half of the sentences, and with one caption token of
  each batch altered.  A step that returns its state unchanged reads 1 on
  ``median_update_gap`` by its definition and needs no run.

The benchmark's runs do not run this.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def tf32(on):
    import torch
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def test_numbers(run):
    import torch

    from portbench import weights as W
    from portbench.drivers import test_split as TS

    cfg, tr, dev = run.cfg, run.traffic, torch.device(run.device)
    ecfg = tr["eval"]
    split = TS.make_split(run.seed, cfg, tr)
    w, st = W.make(cfg, run.seed, dev)
    order = TS.check_rng(run.seed).permutation(len(split))[:TS.CHECK_SLOTS]
    faults = ["token"] + (["greedy", "second_beam"]
                          if ecfg["beam_size"] > 1 else [])
    out = {k: [] for k in ["control"] + ["fault_" + f for f in faults]}

    def judged(served, i):
        return TS.judge(w, st, cfg, ecfg, split[i], served, dev)[0]

    n = held = 0
    with torch.no_grad():
        for i in order:
            if n >= TS.CHECK_IMAGES and held >= TS.CHECK_CAPTIONS:
                break
            tf32(True)
            served = TS.serve_reference(w, st, cfg, ecfg, split[i], dev)
            tf32(False)
            out["control"].append(judged(served, i))
            served = TS.serve_reference(w, st, cfg, ecfg, split[i], dev)
            tok = served["tokens"].copy()
            tok[:, 0] = tok[:, 0] % (cfg["vocab_size"] - 1) + 1
            out["fault_token"].append(judged(dict(served, tokens=tok), i))
            for fault, search in (("greedy", "greedy"),
                                  ("second_beam", "second")):
                if "fault_" + fault in out:
                    out["fault_" + fault].append(judged(TS.serve_reference(
                        w, st, cfg, ecfg, split[i], dev, search), i))
            n, held = n + 1, held + len(served["keep"])
    return {k: TS.worst(v) for k, v in out.items()}


def train_numbers(run):
    import torch

    from portbench.drivers import train_loop as TL
    from portbench.traffic.train_batch import train_batch

    cfg, tr, dev = run.cfg, run.traffic, torch.device(run.device)
    pool = [train_batch(run.seed, i, cfg, tr["batch_images"],
                        tr["seq_per_img"], tr["gpn_batch"])
            for i in range(TL.CHECKED_STEPS)]
    ref = TL.reference_numbers(cfg, tr, run.seed, pool, dev)
    tf32(True)
    control = TL.reference_numbers(cfg, tr, run.seed, pool, dev)
    tf32(False)
    out = {"control": TL.compare(control, ref)}
    for fault in ("half_batch", "token"):
        out["fault_" + fault] = TL.compare(TL.reference_numbers(
            cfg, tr, run.seed, pool, dev, fault=fault), ref)
    return out


def numbers(run):
    tf32(False)
    if run.traffic["driver"] == "test_split":
        return test_numbers(run)
    return train_numbers(run)


def main():
    import argparse
    import json

    from portbench import harness as H

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args()
    bench = H._load_json(os.path.join(H.ROOT, "BENCHMARK.json"))
    for seed in args.seeds:
        t0 = time.perf_counter()
        run = H.Run(bench, args.workload, seed, 0, False)
        out = numbers(run)
        print(json.dumps({"workload": args.workload, "seed": seed, **out,
                          "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
