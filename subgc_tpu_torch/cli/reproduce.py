"""Paper-table reproduction orchestrator —
`python -m subgc_tpu_torch.cli.reproduce --manifest manifest.json
[--models A B] [--device cuda|cpu]`.

The port's counterpart of ``subgc_tpu/cli/reproduce.py``: the same stage
routing, result keys and two-pass rerank-aware grounding, chaining the
port's own CLIs.  ``--device`` (default ``cuda``) goes to every stage that
decodes or runs the rerank NN search.

The reference documents its evaluation as a sequence of MANUAL steps per
model family (`README.md:46-115`): run test.sh, then the diversity /
consensus-reranking / grounding / controllability CLIs by hand — including
a two-pass round trip for rerank-aware grounding (run test, run reranking,
move consensus_rerank_ind.npy next to the checkpoint, run test again,
`misc/eval_utils.py:52-54`).  This orchestrator runs the whole pipeline for
every configured model with one command and writes
``reproduce_summary.json`` + a markdown table.

Manifest schema (all paths; omit sections whose data you don't have —
stages needing them are skipped and marked in the summary):

    {
      "data": {"input_json":.., "input_label_h5":.., "sg_dir":..,
               "mask_dir":.., "packed_path":..(opt)},
      "output": "reproduce_out",                    # summary dir
      "models": {
        "Sub_GC_Kar":  {"checkpoint_path": "logs/kar", "oracle_num": 5,
                        "test_flags": ["--batch_images", "16"]},
        "Sub_GC_MRNN": {"checkpoint_path": "logs/mrnn"},
        "Sub_GC_Flickr_GRD": {"checkpoint_path": "logs/grd",
                              "data": {..per-model override..}}
      },
      "rerank": {"train_annos":.., "feats":.., "top_k": 4, "gts":..(opt)},
      "diversity": {"train_sentences":..(opt)},
      "grounding": {"reference":.., "split_file":..(opt)},
      "controllability": {"sct_dict":.., "img_wh":.., "order_list":..,
                          "gt_captions":.., "noun_glove":..}
    }

Stage routing by MODEL_TYPE (matching test.sh + the paper's tables):
    *_GRD        -> test(+att) -> grounding; with "rerank" data also the
                    rerank-aware second pass (sGPN-dagger numbers)
    *_CTL        -> SCT test -> controllability
    *MRNN*       -> test -> language eval (oracle) -> diversity
    otherwise    -> test -> language eval (top-1 + oracle) -> rerank top-1
"""
from __future__ import annotations

import argparse
import json
import os


def _data_flags(data: dict) -> list:
    flags = []
    for k in ("input_json", "input_label_h5", "sg_dir", "mask_dir",
              "packed_path"):
        if data.get(k):
            flags += [f"--{k}", str(data[k])]
    return flags


def _stages_for(model_type: str) -> list:
    if model_type.endswith("_GRD"):
        return ["test", "grounding", "rerank_grounding"]
    if model_type.endswith("_CTL"):
        return ["test_sct", "controllability"]
    if "MRNN" in model_type:
        return ["test", "language_eval", "diversity"]
    return ["test", "language_eval", "rerank"]


def run_model(model_type: str, mconf: dict, manifest: dict,
              device: str = "cuda") -> dict:
    from . import controllability as ctl_cli
    from . import diversity as div_cli
    from . import grounding as grd_cli
    from . import rerank as rr_cli
    from . import test as test_cli

    data = {**manifest.get("data", {}), **mconf.get("data", {})}
    ckpt = mconf["checkpoint_path"]
    tag = mconf.get("iter_tag", "repro")
    extra = list(mconf.get("test_flags", [])) + ["--device", device]
    result: dict = {}

    def _test(more=()):
        return test_cli.main([model_type, "--checkpoint_path", ckpt,
                              "--iter_tag", tag] + _data_flags(data)
                             + extra + list(more))

    def _clear_rerank_ind():
        # a stale consensus_rerank_ind.npy (from an earlier rerank stage or
        # a previous run on this checkpoint) would silently turn the sGPN
        # grounding pass into rerank-aware numbers — test.py auto-loads it
        rr = os.path.join(ckpt, "consensus_rerank_ind.npy")
        if os.path.exists(rr):
            os.remove(rr)

    # failure/skip messages must land under the same keys the summary
    # consumers read for success
    RESULT_KEY = {"test": "test", "test_sct": "test",
                  "language_eval": "language_eval", "diversity": "diversity",
                  "rerank": "rerank", "grounding": "grounding_sgpn",
                  "rerank_grounding": "grounding_rerank",
                  "controllability": "controllability"}

    for stage in _stages_for(model_type):
        key = RESULT_KEY[stage]
        try:
            if stage == "test":
                _clear_rerank_ind()
                result["test"] = {"captions_path": _test()["captions_path"]}

            elif stage == "test_sct":
                _clear_rerank_ind()
                cfg = manifest.get("controllability", {})
                more = []
                if cfg.get("sct_dict"):
                    more += ["--sct_dict", cfg["sct_dict"]]
                if cfg.get("img_wh"):
                    more += ["--img_wh", cfg["img_wh"]]
                result["test"] = {"captions_path": _test(more)["captions_path"]}

            elif stage == "language_eval":
                oracle = str(mconf.get("oracle_num", 5))
                out = _test(["--only_sent_eval", "1", "--language_eval", "1",
                             "--oracle_num", oracle])
                # the full per-image score matrices live in the saved
                # all_scores_*.npy artifact; the summary keeps the scalars
                result["language_eval"] = {
                    k: out["scores"][k] for k in ("top1", "oracle",
                                                  "bleu_dict")
                    if k in out["scores"]}

            elif stage == "diversity":
                cfg = manifest.get("diversity", {})
                argv = ["--input_file", result["test"]["captions_path"],
                        "--evaluate_mB4"]
                if cfg.get("train_sentences"):
                    argv += ["--train_sentences", cfg["train_sentences"]]
                result["diversity"] = div_cli.main(argv)

            elif stage == "rerank":
                cfg = manifest.get("rerank")
                if not cfg:
                    result["rerank"] = "skipped: no rerank data in manifest"
                    continue
                argv = ["--input_file", result["test"]["captions_path"],
                        "--train_annos", cfg["train_annos"],
                        "--feats", cfg["feats"],
                        "--top_k", str(cfg.get("top_k", 4)),
                        "--device", device]
                if cfg.get("gts"):
                    argv += ["--gts", cfg["gts"]]
                result["rerank"] = rr_cli.main(argv)["scores"] or "reranked"

            elif stage == "grounding":
                cfg = manifest.get("grounding")
                if not cfg:
                    result[key] = "skipped: no grounding refs"
                    continue
                argv = ["--reference", cfg["reference"],
                        "--submission", os.path.join(ckpt,
                                                     "grounding_file.json")]
                if cfg.get("split_file"):
                    argv += ["--split_file", cfg["split_file"]]
                result["grounding_sgpn"] = grd_cli.main(argv)

            elif stage == "rerank_grounding":
                # the reference's manual two-pass round trip, automated:
                # rerank the captions, leave consensus_rerank_ind.npy next to
                # the checkpoint, and re-run test so the grounding collector
                # picks the reranked best sentence (eval_utils.py:52-54)
                rcfg, gcfg = manifest.get("rerank"), manifest.get("grounding")
                if not (rcfg and gcfg):
                    result[key] = "skipped: needs rerank+grounding data"
                    continue
                rr_cli.main(["--input_file", result["test"]["captions_path"],
                             "--train_annos", rcfg["train_annos"],
                             "--feats", rcfg["feats"],
                             "--top_k", str(rcfg.get("top_k", 4)),
                             "--device", device])
                _test()   # pass 2: collector sees consensus_rerank_ind.npy
                argv = ["--reference", gcfg["reference"],
                        "--submission", os.path.join(ckpt,
                                                     "grounding_file.json")]
                if gcfg.get("split_file"):
                    argv += ["--split_file", gcfg["split_file"]]
                result["grounding_rerank"] = grd_cli.main(argv)

            elif stage == "controllability":
                cfg = manifest.get("controllability")
                if not cfg:
                    result["controllability"] = "skipped: no ctl data"
                    continue
                result["controllability"] = ctl_cli.main(
                    ["--input_file", result["test"]["captions_path"],
                     "--order_list", cfg["order_list"],
                     "--gt_captions", cfg["gt_captions"],
                     "--noun_glove", cfg["noun_glove"]])
        except Exception as e:  # record and continue with other stages
            result[key] = f"FAILED: {type(e).__name__}: {e}"
    return result


def _markdown(summary: dict) -> str:
    lines = ["# Reproduction summary", ""]
    for model, stages in summary.items():
        lines.append(f"## {model}")
        for stage, val in stages.items():
            if isinstance(val, dict) and all(
                    isinstance(v, (int, float)) for v in val.values()):
                lines.append(f"* **{stage}**: " + ", ".join(
                    f"{k}={v:.4f}" for k, v in val.items()))
            elif isinstance(val, dict):
                lines.append(f"* **{stage}**: {json.dumps(val, default=str)}")
            else:
                lines.append(f"* **{stage}**: {val}")
        lines.append("")
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--manifest", type=str, required=True)
    p.add_argument("--models", nargs="+", default=None,
                   help="subset of manifest['models'] to run")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the decodes and the rerank NN search run: "
                        "cuda (default) or cpu")
    args = p.parse_args(argv)

    with open(args.manifest) as f:
        manifest = json.load(f)
    out_dir = manifest.get("output", "reproduce_out")
    os.makedirs(out_dir, exist_ok=True)

    summary = {}
    models = args.models or list(manifest["models"])
    for model_type in models:
        print(f"\n===== {model_type} =====")
        summary[model_type] = run_model(model_type,
                                        manifest["models"][model_type],
                                        manifest, args.device)
        # checkpoint the summary after every model (long pipelines)
        with open(os.path.join(out_dir, "reproduce_summary.json"), "w") as f:
            json.dump(summary, f, indent=1, default=str)
    md = _markdown(summary)
    with open(os.path.join(out_dir, "reproduce_summary.md"), "w") as f:
        f.write(md)
    print(md)
    return summary


if __name__ == "__main__":
    main()
