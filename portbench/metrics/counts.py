"""The work a step needs, counted from shapes and from what the inputs hold,
and the least time the card could take for it.

Operations count a multiply-add as 2.  Where the work depends on the data,
the count is what the inputs need: real detections and relations, valid
sub-graphs, kept sub-graphs and the member nodes of each, and the caption
positions the loss covers; not the padding the program may compute on.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense: 67 TFLOP/s float32
outside the tensor cores, 989 TFLOP/s bf16, 3.35 TB/s HBM3.
"""
from __future__ import annotations

F32_PEAK = 67e12
BF16_PEAK = 989e12
HBM_BPS = 3.35e12


def decode_step(cfg, rows, member_nodes):
    """One decoder step of ``rows`` rows that attend over ``member_nodes``
    nodes in all: att-LSTM, additive attention, lang-LSTM and logit
    (``subgc_tpu_torch/utils/profiling.py::decode_flops_per_row``, with the
    row's member nodes in place of every node slot)."""
    R, E, H = cfg["rnn_size"], cfg["input_encoding_size"], cfg["att_hid_size"]
    V1 = cfg["vocab_size"] + 1
    per_row = (2 * R * 4 * R          # h_lang @ w_ih[:R]
               + 2 * E * 4 * R        # word @ w_ih[2R:]
               + 2 * R * 4 * R        # h_att @ w_hh
               + 2 * R * H            # h2att
               + 2 * 2 * R * 4 * R    # [att_res, h_att] @ lang w_ih
               + 2 * R * 4 * R        # h_lang @ lang w_hh
               + 2 * R * V1)          # logit
    return rows * per_row + member_nodes * (2 * H + 2 * R)


def encode_graph(cfg, nodes, rels):
    """Fusion and GCN of one image with ``nodes`` detections and ``rels``
    relations."""
    L, E, F = cfg["gcn_dim"], cfg["embed_dim"], cfg["att_feat_size"]
    fusion = 2 * nodes * F * L + 2 * rels * E * L
    if cfg["noun_fuse"]:
        fusion += 2 * nodes * E * L
    # each unit: two low-rank products (L -> 512 -> L) and the adjacency
    # average; units 0 and 1 read the relations, 2 and 3 the nodes
    unit = 2 * 2 * L * 512
    layer = 2 * rels * unit + 2 * nodes * unit + 2 * rels * L
    return fusion + cfg["gcn_layers"] * layer


def row_inputs(cfg, rows):
    """The fc embedding and its att-LSTM share, per row."""
    L, R, Fc = cfg["gcn_dim"], cfg["rnn_size"], cfg["fc_feat_size"]
    return rows * (2 * 2 * L * Fc + 2 * Fc * R + 2 * R * 4 * R)


def readout(cfg, rows, nodes=0):
    """The read-out projection of ``rows`` rows: the sGPN's (2L -> hid ->
    2L), or Full-GC's mean over ``nodes`` nodes then L -> H -> 2L."""
    L = cfg["gcn_dim"]
    if cfg["use_gpn"]:
        G = cfg["gpn_hid_dim"]
        return rows * (2 * 2 * L * G + 2 * G * 2 * L)
    H = cfg["att_hid_size"]
    return rows * (nodes * L + 2 * L * H + 2 * H * 2 * L)


def node_streams(cfg, nodes):
    """att_embed and ctx2att over ``nodes`` nodes."""
    L, R, H = cfg["gcn_dim"], cfg["rnn_size"], cfg["att_hid_size"]
    return nodes * (2 * L * R + 2 * R * H)


def test_image(cfg, nodes, rels, sub_nodes, kept_rows, kept_nodes, steps,
               beams):
    """Everything one image of the test path needs: the encoder, the sGPN
    over its valid sub-graphs (``sub_nodes``: each one's node count), the
    NMS's pairwise node-set IoU, the kept rows' inputs and ``steps`` decoder
    steps of ``beams`` beams for each kept row (``kept_nodes``: their node
    counts summed)."""
    L, G = cfg["gcn_dim"], cfg["gpn_hid_dim"]
    S = len(sub_nodes)
    sgpn = 2 * L * sum(sub_nodes) + S * (2 * 2 * L * G + 2 * G)
    nms = 2 * S * S * nodes
    return (encode_graph(cfg, nodes, rels) + sgpn + nms
            + readout(cfg, kept_rows) + row_inputs(cfg, kept_rows)
            + node_streams(cfg, nodes)
            + steps * decode_step(cfg, kept_rows * beams,
                                  kept_nodes * beams))


def train_step(cfg, images, nodes, rels, sentence_nodes, sub_nodes,
               positions):
    """One training step (forward and backward, three times the forward):
    ``images`` images of ``nodes`` detections and ``rels`` relations,
    each sentence's attended node count in ``sentence_nodes``, the sGPN's
    scored sub-graphs' node counts in ``sub_nodes`` (empty without an
    sGPN), and ``positions`` caption positions under the loss."""
    L, G, H = cfg["gcn_dim"], cfg["gpn_hid_dim"], cfg["att_hid_size"]
    S = len(sentence_nodes)
    fwd = (images * encode_graph(cfg, nodes, rels)
           + 2 * L * sum(sub_nodes) + len(sub_nodes) * (2 * 2 * L * G + 2 * G)
           + readout(cfg, S, nodes) + row_inputs(cfg, S)
           + node_streams(cfg, sum(sentence_nodes)))
    per_pos = decode_step(cfg, 1, 0)
    fwd += sum(positions) * per_pos + sum(
        p * n * (2 * H + 2 * cfg["rnn_size"])
        for p, n in zip(positions, sentence_nodes))
    return 3 * fwd


def attention_bound_s(S, B, R, G, N, H, D, member_nodes, bf16=False):
    """Least time for one beam-shared attention launch
    (``chip_smoke.py::attention_bound_ms``): compulsory bytes over the HBM
    rate against operations over the peak of their type, for ``S`` rows of
    ``B`` beams over ``G`` images' streams of ``N`` nodes, the rows'
    ``member_nodes`` attended nodes summed.  Returns (seconds, "bytes" or
    "operations")."""
    s = 2 if bf16 else 4
    nbytes = (s * (S * B * R + G * N * (H + D) + R * H + H)
              + 4 * (S * N + S + H + 1 + S * B * (D + N)))
    ops = B * (S * 2 * R * H + member_nodes * (2 * H + 2 * D))
    t_bytes = nbytes / HBM_BPS
    t_ops = ops / (BF16_PEAK if bf16 else F32_PEAK)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
