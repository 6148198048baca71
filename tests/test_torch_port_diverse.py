"""Diverse beam groups in the port held against the JAX package.

``decode/beam.py::beam_search`` at ``group_size`` > 1 against JAX
``beam.beam_search`` (``beam_chunk=0``) on the same weights and features,
in both attention layouts: float32 ``all_seqs`` and ``seq`` exactly,
``all_ps`` and ``logprobs`` within atol 1e-5 (float32 summation order).
The cases cover two groups with and without the decoding constraint and a
length penalty, and four groups of one beam each (the largest stagger).
The bf16 and CLI cases are in ``test_torch_port_diverse_cli.py``.
"""
import numpy as np
import pytest

from subgc_tpu.config import EvalConfig as JEvalConfig
from subgc_tpu.decode import beam as JB
from subgc_tpu_torch.config import EvalConfig
from subgc_tpu_torch.decode import beam as B
from subgc_tpu_torch.models import decoder as D
from subgc_tpu_torch.ops import attention as A

from .test_torch_port_decode import _both_feats, _port_cfg

ATOL = 1e-5
CASES = [(2, 0, ""), (2, 1, ""), (4, 0, ""), (2, 1, "wu_0.5")]


@pytest.mark.parametrize("image_shared", [True, False])
@pytest.mark.parametrize("group_size,constraint,penalty", CASES)
def test_diverse_beam_search_matches_jax(tiny_cfg, tiny_params, image_shared,
                                         group_size, constraint, penalty):
    jf, pf, tp = _both_feats(tiny_cfg, tiny_params, image_shared, seed=5)
    kw = dict(beam_size=4, group_size=group_size, diversity_lambda=0.5,
              decoding_constraint=constraint, length_penalty=penalty)
    j = JB.beam_search(tiny_params[0], jf, tiny_cfg,
                       JEvalConfig(beam_chunk=0, **kw))
    p = B.beam_search(tp, pf, _port_cfg(tiny_cfg), EvalConfig(**kw))
    S, T = jf.fc.shape[0], tiny_cfg.seq_length
    assert p.all_seqs.shape == (S, 4, T)
    np.testing.assert_array_equal(p.all_seqs.numpy(), np.asarray(j.all_seqs))
    np.testing.assert_array_equal(p.seq.numpy(), np.asarray(j.seq))
    np.testing.assert_allclose(p.all_ps.numpy(), np.asarray(j.all_ps),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(p.logprobs.numpy(), np.asarray(j.logprobs),
                               rtol=0, atol=ATOL)


def test_diverse_groups_decode_only_active_steps(tiny_cfg, tiny_params,
                                                 monkeypatch):
    """G x T decode steps, one beam-shared attention call each at B =
    bdash; the JAX form's masked expands of inactive groups are not run."""
    _, pf, tp = _both_feats(tiny_cfg, tiny_params, True, seed=6)
    shapes = []
    real = A.shared_attention

    def spy(h, *a, **k):
        shapes.append(tuple(h.shape))
        return real(h, *a, **k)
    monkeypatch.setattr(D, "shared_attention", spy)
    B.beam_search(tp, pf, _port_cfg(tiny_cfg),
                  EvalConfig(beam_size=6, group_size=3))
    S = pf.fc.shape[0]
    assert shapes == [(S, 2, tiny_cfg.rnn_size)] * (3 * tiny_cfg.seq_length)
    with pytest.raises(ValueError, match="multiple of group_size"):
        B.beam_search(tp, pf, _port_cfg(tiny_cfg),
                      EvalConfig(beam_size=5, group_size=2))
