"""Consensus reranking (misc/consensus_reranking/).

Pipeline (cr_mRNN_demo.py + concensus_reranking_utils/consensus_reranking.py):
1. take the top-k (default 4) sGPN-ranked captions per test image,
2. find the k=60 nearest training images by euclidean distance on global
   image features (ResNet-101 2048-d in the reference),
3. score each hypothesis by the summed top m=125 pairwise CIDEr similarities
   against the retrieved images' GT sentences,
4. rerank, write consensus_rerank_ind.npy, and COCO-eval the new top-1.

Changes vs the reference:
* the NN search is one batched matmul-based distance on the device instead
  of a per-image scipy cdist loop (consensus_reranking.py:104-119); here a
  torch matmul + top-k on the card, with no fallback to numpy,
* pairwise CIDEr vectors are computed ONCE per unique sentence instead of
  per (hypothesis, reference) pair (the reference recomputes both vectors
  inside the inner loop — hours at scale, SURVEY.md §3.4).

The port's own copy of ``subgc_tpu/eval/rerank.py``, held equal to it
by ``tests/test_torch_port_metrics.py``.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from .pairwise import pairwise_cider_matrix
from .tokenizer import tokenize


@contextlib.contextmanager
def _full_float32():
    """Matmuls in full float32 (TF32 off), as the JAX package computes the
    distances."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _smallest_k(d2: torch.Tensor, k: int) -> torch.Tensor:
    """[rows, k] column indices of each row's k smallest values, smallest
    first and equal values in index order, as ``jax.lax.top_k`` gives them.
    ``torch.topk`` alone picks among ties differently on the CPU and on the
    card, so it only finds each row's k-th value: every column below it is
    taken, then the lowest-indexed columns equal to it."""
    kth = torch.topk(d2, k, dim=1, largest=False,
                     sorted=False).values.amax(1, keepdim=True)
    below = d2 < kth
    tied = d2 == kth
    need = k - below.sum(1, keepdim=True)
    take = below | (tied & (tied.cumsum(1, dtype=torch.int32) <= need))
    cols = take.nonzero()[:, 1].view(d2.shape[0], k)   # ascending per row
    order = torch.sort(d2.gather(1, cols), dim=1, stable=True).indices
    return cols.gather(1, order)


def find_nn_images(test_feats, train_feats, num_nn: int = 1000,
                   batch: int = 512, device="cuda") -> np.ndarray:
    """[num_te, num_nn] indices of nearest train images (euclidean), nearest
    first, equal distances in index order.

    Uses |a-b|^2 = |a|^2 + |b|^2 - 2ab in float32 as batched matmuls, one
    chunk of ``batch`` test rows at a time against train features that stay
    on the device.  The features are numpy arrays or tensors (already on
    ``device`` they are not copied).  Runs on the card unless the caller
    passes ``device="cpu"``, and raises when there is no card to run on.
    """
    dev = resolve_device(device)
    k = min(num_nn, train_feats.shape[0])
    outs = []
    with torch.no_grad(), _full_float32():
        tr = torch.as_tensor(train_feats, dtype=torch.float32, device=dev)
        tr_sq = (tr * tr).sum(-1)
        for i in range(0, test_feats.shape[0], batch):
            te = torch.as_tensor(test_feats[i:i + batch],
                                 dtype=torch.float32, device=dev)
            d2 = (te * te).sum(-1, keepdim=True) + tr_sq[None, :] \
                - 2.0 * te @ tr.T
            outs.append(_smallest_k(d2, k).cpu().numpy())
    return np.concatenate(outs, 0)


def select_top_captions(predictions: List[dict], top_k: int = 4,
                        rand_k: Optional[int] = None,
                        seed: int = 2019) -> List[dict]:
    """captions_*.npy -> mRNN-format list (cr_mRNN_demo.py:43-61)."""
    rng = np.random.RandomState(seed)
    out = []
    for item in predictions:
        caps = item["caption"]
        if rand_k is None:
            chosen = [caps[i].split(" ") for i in range(min(top_k, len(caps)))]
        else:
            ind = rng.choice(len(caps), min(rand_k, len(caps)), replace=False)
            chosen = [caps[i].split(" ") for i in ind]
        out.append({"id": item["image_id"], "caption": chosen})
    return out


def consensus_rerank(hypo_list: List[dict], ref_annos: List[dict],
                     nn_list: np.ndarray, df_refs: Dict[object, List[str]],
                     k: int = 60, m: int = 125) -> Dict[object, List[int]]:
    """Returns {image_id: reranked hypothesis order} (consensus_rerank_ind).

    hypo_list: [{'id', 'caption': [[tok, ...], ...]}]
    ref_annos: [{'id', 'sentences': [str]}] aligned with nn_list columns
    df_refs:   {img_id: [raw ref strings]} — corpus for the CIDEr
               document-frequency table (the eval annotation set, matching
               COCOEvalCapPairCider.setup)
    """
    df_tok = tokenize({kk: [{"caption": c} for c in v]
                       for kk, v in df_refs.items()})
    df_docs = list(df_tok.values())

    rerank_ind: Dict[object, List[int]] = {}
    for ind_te, anno in enumerate(hypo_list):
        retrieved: List[str] = []
        for ind_nn in range(min(k, nn_list.shape[1])):
            retrieved += ref_annos[int(nn_list[ind_te][ind_nn])]["sentences"]
        hyps = [" ".join(sen) for sen in anno["caption"]]
        sim_mtx = pairwise_cider_matrix(df_docs, hyps, retrieved)
        top = np.sort(sim_mtx, axis=1)[:, ::-1][:, :m]
        sims = top.sum(axis=1)
        arg = np.argsort(-sims).tolist()
        anno["reranked"] = [anno["caption"][x] for x in arg]
        rerank_ind[anno["id"]] = arg
    return rerank_ind


def rerank_predictions(predictions: List[dict], train_annos: List[dict],
                       train_feats: np.ndarray, test_feats: np.ndarray,
                       df_refs: Dict[object, List[str]], top_k: int = 4,
                       k: int = 60, m: int = 125, num_nn: int = 1000,
                       device="cuda"):
    """Full pipeline, the NN search on ``device``.  Returns (rerank_ind
    dict, top1 {img_id: caption str})."""
    hypo = select_top_captions(predictions, top_k=top_k)
    nn = find_nn_images(test_feats, train_feats, num_nn=num_nn,
                        device=device)
    rerank_ind = consensus_rerank(hypo, train_annos, nn, df_refs, k=k, m=m)
    top1 = {h["id"]: " ".join(h["reranked"][0]) for h in hypo}
    return rerank_ind, top1
