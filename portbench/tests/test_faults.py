"""The output check fails a run whose timed path is broken: each cell driven
through the harness at small widths on the CPU, sound and then with one
fault planted in the program, and ``correct`` has to come out false on a
number that the sound run passes."""
from __future__ import annotations

import pytest
import torch

from conftest import failing, small_run
from portbench import harness as H

TEST_CELLS = ["sub_gc.kar_test", "sub_gc.mrnn_test"]
TRAIN_CELLS = ["full_gc.kar_train", "sub_gc.kar_train"]


def _token_altered(patch):
    """Every decode returns its first row's first token altered, where the
    decode produces it."""
    from subgc_tpu_torch.decode import beam, greedy

    def alter(fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            seq = out.seq.clone()
            seq[0, 0] = seq[0, 0] % 50 + 1
            return out._replace(seq=seq)
        return wrapped

    patch(beam, "beam_search", alter(beam.beam_search))
    patch(greedy, "sample", alter(greedy.sample))


def _score_altered(patch):
    """The encoder returns every kept sub-graph's score 1e-3 high."""
    from subgc_tpu_torch.models import subgc
    enc = subgc.encode_images_batched

    def wrapped(*a, **k):
        out = enc(*a, **k)
        return out._replace(scores=out.scores + 1e-3)

    patch(subgc, "encode_images_batched", wrapped)


def _greedy_for_beam(patch):
    """The beam search decodes greedily."""
    from subgc_tpu_torch.decode import beam, greedy

    def greedy_search(params, feats, cfg, ecfg):
        out = greedy.sample(params, feats, cfg, ecfg)
        return beam.BeamOut(seq=out.seq, logprobs=out.logprobs,
                            all_seqs=out.seq[:, None],
                            all_ps=out.logprobs.sum(-1, keepdim=True))

    patch(beam, "beam_search", greedy_search)


def _second_beam(patch):
    """The beam search serves its second best done beam."""
    from subgc_tpu_torch.decode import beam
    top_done = beam._top_done

    def swapped(gs, bdash):
        return tuple(torch.cat([x[:, 1:2], x[:, :1], x[:, 2:]], 1)
                     for x in top_done(gs, bdash))

    patch(beam, "_top_done", swapped)


def _state_unchanged(patch):
    """The optimizer step leaves the parameters and its state as they
    were."""
    from subgc_tpu_torch.train import step

    def no_update(params, grads, opt, lr, tcfg):
        return opt, torch.zeros(())

    patch(step.optim, "apply_update", no_update)


def _half_batch(patch):
    """The language loss is the mean over the first half of the
    sentences."""
    from subgc_tpu_torch.train import step
    lm = step.language_model_loss

    def half(logprobs, targets, masks):
        n = logprobs.shape[0] // 2
        return lm(logprobs[:n], targets[:n], masks[:n])

    patch(step, "language_model_loss", half)


def _train_token_altered(patch):
    """Each batch reaches the step with its first caption's first word
    altered."""
    from subgc_tpu_torch.train import step
    place = step.batch_to_device

    def altered(batch, device, non_blocking=False):
        out = place(batch, device, non_blocking)
        labels = out.labels.clone()
        labels[0, 1] = labels[0, 1] % 50 + 1
        return out._replace(labels=labels)

    patch(step, "batch_to_device", altered)


FAULTS = {"token": _token_altered, "score": _score_altered,
          "greedy_for_beam": _greedy_for_beam, "second_beam": _second_beam,
          "state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "train_token": _train_token_altered}


@pytest.fixture(scope="module")
def sound():
    """Each cell's sound result at small widths."""
    return {name: H.execute(small_run(name))
            for name in TEST_CELLS + TRAIN_CELLS}


@pytest.mark.parametrize("name", TEST_CELLS + TRAIN_CELLS)
def test_sound_run_passes_what_the_faults_fail(sound, name):
    out = sound[name]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert failing(out) == set()


@pytest.mark.parametrize("name,fault", [
    (c, f) for c in TEST_CELLS for f in ("token", "score")] + [
    ("sub_gc.kar_test", f) for f in ("greedy_for_beam", "second_beam")] + [
    (c, f) for c in TRAIN_CELLS
    for f in ("state_unchanged", "half_batch", "train_token")])
def test_fault_comes_out_incorrect(sound, restore_modules, name, fault):
    FAULTS[fault](restore_modules)
    out = H.execute(small_run(name))
    assert out["correct"] is False
    assert failing(out) - failing(sound[name])
