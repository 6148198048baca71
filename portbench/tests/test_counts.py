"""The work counts against hand counts at one small shape, and the trace
reader on a made-up trace."""
from __future__ import annotations

import types

import pytest
from torch.autograd import DeviceType

from portbench.metrics import counts
from portbench.metrics.trace import WINDOW, NoDeviceWork, Trace

CFG = dict(rnn_size=4, input_encoding_size=3, att_hid_size=2, vocab_size=5,
           gcn_dim=2, embed_dim=3, att_feat_size=6, noun_fuse=True,
           gcn_layers=1, fc_feat_size=5, gpn_hid_dim=3, use_gpn=True,
           obj_num=4)


def test_decode_step_by_hand():
    # att-LSTM 2*4*16 + 2*3*16 + 2*4*16, h2att 2*4*2, lang 2*8*16 + 2*4*16,
    # logit 2*4*6: 128+96+128+16+256+128+48 = 800 a row; 2 nodes a row:
    # 2 * (2*2 + 2*4) = 24
    assert counts.decode_step(CFG, 1, 0) == 800
    assert counts.decode_step(CFG, 3, 2) == 3 * 800 + 2 * 12


def test_encoder_and_test_image_by_hand():
    # fusion 2*3*6*2 + 2*5*3*2 + 2*3*3*2 = 72 + 60 + 36; one layer: units
    # 2*2*2*512 = 4096 each, 2*5 + 2*3 of them, 2*5*2 adds
    enc = counts.encode_graph(CFG, 3, 5)
    assert enc == 168 + 16 * 4096 + 20
    # sGPN: pooling 2*2*(2+3) + 2 sub-graphs * (2*4*3 + 2*3); NMS 2*2*2*3;
    # one kept row: read-out 2*4*3 + 2*3*4, inputs 2*4*5 + 2*5*4 + 2*4*16,
    # node streams 3 * (2*2*4 + 2*4*2), 2 steps of 2 beams of 2 nodes each
    total = counts.test_image(CFG, 3, 5, [2, 3], 1, 2, 2, 2)
    assert total == (enc + 20 + 60 + 24 + 48 + 208 + 3 * 32
                     + 2 * counts.decode_step(CFG, 2, 4))


def test_training_step_is_three_forwards():
    fwd = (counts.encode_graph(CFG, 3, 5) + 2 * 2 * 5 + 1 * (2 * 4 * 3 + 6)
           + counts.readout(CFG, 1) + counts.row_inputs(CFG, 1)
           + counts.node_streams(CFG, 2) + 4 * counts.decode_step(CFG, 1, 2))
    assert counts.train_step(CFG, 1, 3, 5, [2], [5], [4]) == 3 * fwd


def test_attention_bound_by_hand():
    # S=2 rows of B=1 beam over G=1 image of N=3 nodes, R=4, H=2, D=4,
    # 4 member nodes: ops 2*2*4*2 + 4*(2*2+2*4) = 80; bytes 4*(8 + 18 + 8
    # + 2) + 4*(6 + 2 + 2 + 1 + 2*7) = 244; in bf16 the first sum counts 2
    # bytes an element: 172
    t, kind = counts.attention_bound_s(2, 1, 4, 1, 3, 2, 4, 4)
    assert kind == "bytes" and t == pytest.approx(244 / counts.HBM_BPS)
    t, kind = counts.attention_bound_s(2, 1, 4, 1, 3, 2, 4, 4, bf16=True)
    assert t == pytest.approx(max(172 / counts.HBM_BPS,
                                  80 / counts.BF16_PEAK))


def _event(name, start, dur, dev):
    return types.SimpleNamespace(
        name=lambda: name, start_ns=lambda: start, duration_ns=lambda: dur,
        device_type=lambda: dev)


def _prof(events):
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))


def test_trace_unions_overlapping_spans_and_labels_gaps():
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    t = Trace(_prof([
        _event(WINDOW, 0, 1000, cpu),
        _event("portbench.decode", 100, 800, cpu),
        _event("aten::item", 600, 100, cpu),
        _event("portbench.decode", 100, 800, cuda),   # a mirrored annotation
        _event("k1", 100, 300, cuda),
        _event("k2", 200, 300, cuda),                  # overlaps k1
        _event("memcpy", 800, 100, cuda),
        _event("k1", 1500, 10, cuda),                  # outside the window
    ]))
    assert t.window_s == pytest.approx(1e-6)
    assert t.busy_s == pytest.approx(500e-9)
    assert t.time_of("k1") == pytest.approx(300e-9)
    assert t.device_ops()[0] == ["k1", pytest.approx(300e-9)]
    gaps = dict(t.idle_gaps())
    assert gaps["portbench.decode/aten::item"] == pytest.approx(300e-9)
    assert gaps["outside the layers"] == pytest.approx(200e-9)


def test_trace_without_device_work_fails():
    with pytest.raises(NoDeviceWork):
        Trace(_prof([_event(WINDOW, 0, 1000, DeviceType.CPU),
                     _event("k1", 2000, 10, DeviceType.CUDA)]))
