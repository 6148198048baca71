"""The beam-shared attention kernels' share of their roofline
(``ops/csrc/attention.cu``: the projection, its split sum and the attend
kernel): the least time the traced window's launches need, counted from
the kept rows and their member nodes (``counts.attention_bound_s``), over
the device time of those kernels in the trace, in percent."""
from portbench.metrics import counts

KERNELS = ("project_kernel", "project_sum_kernel", "attend_kernel")


def read(layers):
    trace, work = layers.get("trace"), layers.get("work")
    if trace is None or not work or not layers.get("launches"):
        return None
    spent = trace.time_of(*KERNELS)
    if spent <= 0:
        return None
    cfg, tr = layers["cfg"], layers["traffic"]
    B = tr["batch_images"]
    dispatches = [work[i:i + B] for i in range(0, len(work), B)]
    per_dispatch = layers["launches"] / (layers["traced_calls"]
                                         * len(dispatches))
    bound = 0.0
    for d in dispatches:
        bound += counts.attention_bound_s(
            sum(k for _, k, _ in d), tr["eval"]["beam_size"],
            cfg["rnn_size"], len(d), cfg["obj_num"], cfg["att_hid_size"],
            cfg["rnn_size"], sum(n for _, _, n in d))[0]
    return 100.0 * per_dispatch * bound * layers["traced_calls"] / spent
