"""Convert a reference PyTorch checkpoint (``model-*.pth``) to the port's
parameter layout — the port's counterpart of ``tools/convert_torch_ckpt.py``,
with the same functions and flags, and no JAX.

The reference ships pretrained ``model-60000.pth`` state_dicts with an
``infos_*.pkl`` beside each; this maps them onto the parameter tree both
packages share, so paper-parity evaluation runs without retraining:

    python -m subgc_tpu_torch.cli.convert_ckpt --pth model-60000.pth \\
        --infos infos_topdown-60000.pkl --out logs/sub_gc_karpathy
    python -m subgc_tpu_torch.cli.test Sub_GC_Kar \\
        --checkpoint_path logs/sub_gc_karpathy

(the directory form: ``model.npz`` + ``infos.json``, which ``cli/test.py``,
``cli/serve.py``, ``cli/train.py --start_from`` and ``setup(start_from=)``
of either package read), or ``python -m subgc_tpu_torch.cli.convert_ckpt
model-60000.pth out.npz [--full-gc] [--use-gt-subg] [--vocab-size V]``
(the legacy form: one ``{"params", "state"}`` npz).

Layout differences handled here:

* torch Linear stores weight [out, in]; the port stores [in, out];
* LSTMCell ``weight_ih`` / ``weight_hh`` [4H, in] -> ``w_ih`` / ``w_hh``
  [in, 4H] (gate order i, f, g, o is kept);
* BatchNorm running statistics go to the separate ``state`` tree; the
  reference's ``num_batches_tracked`` counters are not read;
* ``att_embed``'s Sequential indices shift with ``use_bn``.

The ``.pth`` is read by torch itself with ``weights_only=True``; the infos
pickle (an ``argparse.Namespace`` under ``opt``) with ``encoding="latin1"``,
so only open infos files from a source you trust, as with any pickle.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import re
from typing import Dict, Tuple

import numpy as np


def _lin(sd, prefix):
    return {"w": np.ascontiguousarray(sd[prefix + ".weight"].T.astype(np.float32)),
            "b": sd[prefix + ".bias"].astype(np.float32)}


def _lstm(sd, prefix):
    return {"w_ih": np.ascontiguousarray(sd[prefix + ".weight_ih"].T.astype(np.float32)),
            "w_hh": np.ascontiguousarray(sd[prefix + ".weight_hh"].T.astype(np.float32)),
            "b_ih": sd[prefix + ".bias_ih"].astype(np.float32),
            "b_hh": sd[prefix + ".bias_hh"].astype(np.float32)}


def _bn(sd, prefix):
    return {"scale": sd[prefix + ".weight"].astype(np.float32),
            "bias": sd[prefix + ".bias"].astype(np.float32)}


def _bn_stats(sd, prefix):
    return {"mean": sd[prefix + ".running_mean"].astype(np.float32),
            "var": sd[prefix + ".running_var"].astype(np.float32)}


def torch_state_dict_to_params(sd: Dict[str, np.ndarray],
                               cfg) -> Tuple[dict, dict]:
    """sd: {torch name: np.ndarray}.  Returns the (params, state) numpy
    trees of ``models/params.py``'s layout for the ModelConfig ``cfg``."""
    params: dict = {}
    state: dict = {}

    fusion = {"obj_v_proj": _lin(sd, "obj_v_proj")}
    if cfg.noun_fuse:
        fusion["obj_emb"] = sd["sg_obj_embed.weight"].astype(np.float32)
        fusion["obj_emb_proj"] = _lin(sd, "obj_emb_proj")
    fusion["pred_emb"] = sd["sg_pred_embed.weight"].astype(np.float32)
    fusion["pred_emb_proj"] = _lin(sd, "pred_emb_prj")
    params["fusion"] = fusion

    gcn_layers, gcn_state = [], []
    for i in range(cfg.gcn_layers):
        units, ustate = [], []
        for u in range(4):
            pre = f"gcn_backbone.gcn.{i}.gcn_collect.collect_units.{u}"
            unit = {"lft": _lin(sd, pre + ".fc_lft"),
                    "rgt": _lin(sd, pre + ".fc_rgt")}
            if cfg.gcn_bn:
                unit["bn"] = _bn(sd, pre + ".bn")
                ustate.append(_bn_stats(sd, pre + ".bn"))
            else:
                ustate.append({})
            units.append(unit)
        gcn_layers.append(units)
        gcn_state.append(ustate)
    params["gcn"] = gcn_layers
    state["gcn_bn"] = gcn_state

    if cfg.use_gpn:
        gpn = {}
        if not cfg.use_gt_subg:
            gpn["fc1"] = _lin(sd, "gpn_layer.gpn_fc.0")
            gpn["fc2"] = _lin(sd, "gpn_layer.gpn_fc.3")
        gpn["readout1"] = _lin(sd, "gpn_layer.read_out_proj.0")
        gpn["readout2"] = _lin(sd, "gpn_layer.read_out_proj.1")
        params["gpn"] = gpn
    else:
        params["readout"] = {"readout1": _lin(sd, "read_out_proj.0"),
                             "readout2": _lin(sd, "read_out_proj.1")}

    # att_embed's Sequential indices shift with use_bn (AttModel.py:114-119):
    # use_bn=0 -> [Linear, ReLU, Dropout]; use_bn=1 -> [BN, Linear, ...];
    # use_bn=2 also appends a trailing BN at index 4
    att_lin = f"att_embed.{1 if cfg.use_bn else 0}"
    params["decoder"] = {
        "embed": sd["embed.0.weight"].astype(np.float32),
        "fc_embed1": _lin(sd, "fc_embed.0"),
        "fc_embed2": _lin(sd, "fc_embed.2"),
        "att_embed": _lin(sd, att_lin),
        "ctx2att": _lin(sd, "ctx2att"),
        "att_lstm": _lstm(sd, "core.att_lstm"),
        "lang_lstm": _lstm(sd, "core.lang_lstm"),
        "h2att": _lin(sd, "core.attention.h2att"),
        "alpha_net": _lin(sd, "core.attention.alpha_net"),
        "logit": _lin(sd, "logit"),
    }
    if cfg.use_bn:
        dec = params["decoder"]
        dec["att_bn0"] = _bn(sd, "att_embed.0")
        att_bn = {"bn0": _bn_stats(sd, "att_embed.0")}
        if cfg.use_bn == 2:
            dec["att_bn1"] = _bn(sd, "att_embed.4")
            att_bn["bn1"] = _bn_stats(sd, "att_embed.4")
        state["att_bn"] = att_bn
    return params, state


# reference opt attribute -> ModelConfig field (identity); only fields
# ModelConfig owns are copied, the rest of the namespace is train / eval
# config and data paths
_OPT_TO_MCFG = ("vocab_size", "seq_length", "input_encoding_size",
                "rnn_size", "num_layers", "att_hid_size", "fc_feat_size",
                "att_feat_size", "drop_prob_lm", "use_bn", "embed_dim",
                "gcn_dim", "gcn_layers", "gcn_residual", "gcn_bn",
                "noun_fuse", "pred_emb_type", "use_gpn", "use_gt_subg",
                "obj_num", "rel_num")


def config_from_ref_infos(infos):
    """A ModelConfig from a reference infos pickle's ``opt`` namespace
    (`test.py:173-196` treats ``infos['opt']`` as the source of truth).
    Missing attributes keep ModelConfig's defaults; int-ish reference flags
    (``noun_fuse`` / ``gcn_bn`` as 0/1) become the fields' bools."""
    from ..config import ModelConfig
    opt = infos.get("opt")
    kw = {}
    for f in _OPT_TO_MCFG:
        if opt is not None and hasattr(opt, f):
            v = getattr(opt, f)
            if isinstance(getattr(ModelConfig, f), bool):
                v = bool(v)
            kw[f] = v
    if "vocab_size" not in kw and infos.get("vocab"):
        kw["vocab_size"] = len(infos["vocab"])
    return ModelConfig(**kw)


def load_state_dict(pth: str) -> Dict[str, np.ndarray]:
    """A reference ``model-*.pth`` as {torch name: numpy array}, read by
    torch with ``weights_only=True`` (tensors only, no code)."""
    import torch
    sd = torch.load(pth, map_location="cpu", weights_only=True)
    return {k: v.numpy() for k, v in sd.items()}


def convert_to_checkpoint_dir(pth: str, infos_pkl: str, out_dir: str,
                              model_type: str = None) -> None:
    """Reference ``model-*.pth`` + ``infos_*.pkl`` -> a checkpoint directory
    (``model.npz`` + ``infos.json``)."""
    from ..config import TEST_PRESETS, config_to_json
    from ..models.params import save_model_npz

    with open(infos_pkl, "rb") as f:      # written under Python 2 or 3
        infos_ref = pickle.load(f, encoding="latin1")
    cfg = config_from_ref_infos(infos_ref)
    params, state = torch_state_dict_to_params(load_state_dict(pth), cfg)

    os.makedirs(out_dir, exist_ok=True)
    save_model_npz(os.path.join(out_dir, "model.npz"),
                   {"params": params, "state": state})
    m = re.search(r"model-(\d+)", os.path.basename(pth))
    # the reference infos' opt.id is a run id ("topdown", train.sh:4), not
    # a preset name — only trust it if it actually resolves in the preset
    # registry, else default to Sub_GC_Kar so the converted dir loads
    ref_id = getattr(infos_ref.get("opt"), "id", None)
    if model_type is None:
        model_type = ref_id if ref_id in TEST_PRESETS else "Sub_GC_Kar"
        if ref_id is not None and ref_id not in TEST_PRESETS:
            print(f"[convert] reference opt.id {ref_id!r} is not a preset; "
                  f"writing model_type=Sub_GC_Kar (override with "
                  f"--model_type)")
    infos = {
        "model_config": config_to_json(cfg),
        "model_type": model_type,
        "vocab": {str(k): v for k, v in infos_ref.get("vocab", {}).items()},
        "iter": infos_ref.get("iter", int(m.group(1)) if m else 0),
        "epoch": infos_ref.get("epoch", 0),
        "converted_from": os.path.abspath(pth),
    }
    with open(os.path.join(out_dir, "infos.json"), "w") as f:
        json.dump(infos, f)
    print(f"wrote {out_dir}/model.npz + infos.json "
          f"(iter {infos['iter']}, vocab {len(infos['vocab'])})")


def legacy_config(full_gc: bool = False, use_gt_subg: bool = False,
                  vocab_size: int = 9487):
    """The legacy form's ModelConfig: the Sub-GC defaults, or with
    ``full_gc`` the Full-GC baseline (GCN BatchNorm, 4 layers, residual 1,
    no sGPN)."""
    from ..config import ModelConfig
    if full_gc:
        return ModelConfig(vocab_size=vocab_size, noun_fuse=False,
                           pred_emb_type=2, gcn_layers=4, gcn_residual=1,
                           gcn_bn=True, use_gpn=False)
    return ModelConfig(vocab_size=vocab_size, use_gt_subg=use_gt_subg)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    # directory form: --pth model-60000.pth --infos infos.pkl --out DIR;
    # legacy npz form: positional CKPT OUT.npz
    ap.add_argument("ckpt", nargs="?")
    ap.add_argument("out_npz", nargs="?")
    ap.add_argument("--pth")
    ap.add_argument("--infos")
    ap.add_argument("--out")
    ap.add_argument("--model_type", default=None)
    ap.add_argument("--full-gc", action="store_true")
    ap.add_argument("--use-gt-subg", action="store_true")
    ap.add_argument("--vocab-size", type=int, default=9487)
    args = ap.parse_args(argv)

    if args.pth:
        if not (args.infos and args.out):
            raise SystemExit("--pth requires --infos and --out DIR")
        convert_to_checkpoint_dir(args.pth, args.infos, args.out,
                                  model_type=args.model_type)
        return
    if not (args.ckpt and args.out_npz):
        raise SystemExit("usage: convert_ckpt.py CKPT OUT.npz "
                         "[--full-gc] | --pth P --infos I --out DIR")

    from ..models.params import save_model_npz
    cfg = legacy_config(args.full_gc, args.use_gt_subg, args.vocab_size)
    params, state = torch_state_dict_to_params(load_state_dict(args.ckpt),
                                               cfg)
    save_model_npz(args.out_npz, {"params": params, "state": state})
    print(f"wrote {args.out_npz}")


if __name__ == "__main__":
    main()
