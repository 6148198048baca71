"""The port's input pipeline and profiling against the JAX package:

* ``data/prefetch.py::BatchPrefetcher`` yields ``get_batch``'s order with
  its aux values, raises a producer failure in the consumer, and stops
  (its thread ends) with the producer blocked on a full queue;
* ``utils/profiling.py``: ``PhaseTimers`` summaries and reports equal
  JAX's;
* ``cli/train.py --trace_steps 1:1`` writes a Chrome trace on the CPU and
  the spans recorded under it (the traced step's), and prints the
  ``data`` / ``step`` phase report (the prefetched train CLI
  against the JAX CLI is ``test_torch_port_prefetch_cli.py``);
* ``data/surgery.py``'s ``filter_dets`` and ``export_image`` equal JAX's;
* ``data/synthetic.py::generate_dataset`` writes the JAX generator's files
  from the same seed, and ``cli/time_loader.py`` times ``get_batch`` four
  ways (npz or packed, C++ or Python sampler).
"""
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from subgc_tpu.data import surgery as JS
from subgc_tpu.data.synthetic import generate_dataset as j_generate
from subgc_tpu.io.sg_npz import read_feat_npz as j_read
from subgc_tpu.utils import profiling as JPR
from subgc_tpu_torch.cli import time_loader
from subgc_tpu_torch.cli import train as p_cli
from subgc_tpu_torch.data import surgery as S
from subgc_tpu_torch.data.prefetch import BatchPrefetcher
from subgc_tpu_torch.data.synthetic import generate_dataset
from subgc_tpu_torch.io.sg_npz import read_feat_npz
from subgc_tpu_torch.utils import profiling as PR

from .test_torch_port_train_cli import (_data_flags, _dim_flags,
                                        data)  # noqa: F401


def test_prefetcher_keeps_order_and_aux():
    counter = iter(range(1000))

    def get_batch():
        i = next(counter)
        return {"x": torch.full((2,), float(i))}, f"info{i}", i % 3 == 2

    pf = BatchPrefetcher(get_batch, depth=2)
    try:
        for i in range(7):
            batch, (info, wrapped) = pf.next()
            assert batch["x"].tolist() == [float(i)] * 2
            assert info == f"info{i}" and wrapped == (i % 3 == 2)
    finally:
        pf.stop()
    assert not pf.thread.is_alive()


def test_prefetcher_raises_the_workers_failure():
    calls = []

    def get_batch():
        calls.append(1)
        if len(calls) == 3:
            raise KeyError("bad image 42")
        return (np.zeros(1), None)

    pf = BatchPrefetcher(get_batch, depth=2,
                         place=lambda b: torch.from_numpy(b))
    try:
        pf.next()
        pf.next()
        with pytest.raises(RuntimeError, match="prefetch worker failed") \
                as err:
            pf.next()
        assert isinstance(err.value.__cause__, KeyError)
    finally:
        pf.stop()
    assert not pf.thread.is_alive()


def test_prefetcher_stops_with_the_producer_blocked():
    started = threading.Event()

    def get_batch():
        started.set()
        return (torch.zeros(1),)

    pf = BatchPrefetcher(get_batch, depth=1)
    assert started.wait(10)
    time.sleep(0.3)              # the queue is full, the producer waits
    pf.stop(timeout=10)
    assert not pf.thread.is_alive()


def test_profiling_equals_jax():
    pt, jt = PR.PhaseTimers(), JPR.PhaseTimers()
    for name, dt in [("data", 0.25), ("step", 1.5), ("data", 0.125),
                     ("scst_step", 3.0)]:
        for t in (pt, jt):
            t.totals[name] += dt
            t.counts[name] += 1
    assert pt.summary() == jt.summary()
    assert pt.report() == jt.report()
    with pt.phase("step", sync="cpu"):
        torch.ones(3) * 2
    assert pt.counts["step"] == 2 and pt.totals["step"] > 1.5


def _train_flags(man, out, extra=(), preset="Sub_GC_Kar"):
    return ([preset, "--checkpoint_path", out, "--batch_size", "2",
             "--save_checkpoint_every", "3", "--val_images_use", "2",
             "--losses_log_every", "1", "--max_iters", "3"]
            + _dim_flags() + _data_flags(man) + list(extra))


def test_trace_steps_write_a_trace_on_cpu(data, capsys):  # noqa: F811
    root, man = data
    out = str(root / "port_trace")
    res = p_cli.main(_train_flags(man, out, ["--device", "cpu",
                                             "--trace_steps", "1:1"]))
    assert res == {"iter": 3, "epoch": 0}
    path = os.path.join(out, "trace", "trace.json")
    with open(path) as f:
        trace = json.load(f)
    assert len(trace["traceEvents"]) > 0
    with open(os.path.join(out, "trace", "spans.json")) as f:
        spans = json.load(f)
    steps = [s for s in spans if s["name"] == "subgc.train.step"]
    assert len(steps) == 1
    assert set(spans[0]) == {"name", "start_ns", "end_ns", "parent",
                             "thread"}
    for s in spans:
        assert s["start_ns"] <= s["end_ns"]
        assert -1 <= s["parent"] < len(spans)
    assert {s["name"] for s in spans if s["parent"] >= 0
            and spans[s["parent"]]["name"] == "subgc.train.step"} == {
        "subgc.train.forward", "subgc.train.backward", "subgc.train.optim"}
    log = capsys.readouterr().out
    assert "device trace (1:2)" in log
    for phase in ("data", "step"):
        assert any(line.strip().startswith(f"{phase}:")
                   and "/      3 =" in line for line in log.splitlines())


def _dets(seed):
    rng = np.random.RandomState(seed)
    n, k = 40, 90
    return dict(boxes=rng.rand(n, 4), obj_scores=rng.rand(n),
                obj_dist=rng.rand(n, 20), obj_fmap=rng.rand(n, 64),
                rel_inds=rng.randint(0, n, (k, 2)),
                pred_scores=rng.dirichlet(np.ones(5), k))


@pytest.mark.parametrize("kw", [dict(), dict(nonbg_thresh=0.2, max_rels=8),
                                dict(nonbg_thresh=0.999)])
def test_surgery_equals_jax(tmp_path, kw):
    dets = _dets(len(kw))
    got, want = S.filter_dets(**dets, **kw), JS.filter_dets(**dets, **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    p = S.export_image(str(tmp_path / "p"), 17, **dets)
    j = JS.export_image(str(tmp_path / "j"), 17, **dets)
    assert os.path.basename(p) == os.path.basename(j) == "17.npz"
    a, b = read_feat_npz(p), j_read(j)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])


def _same_tree(a, b):
    if isinstance(b, dict):
        assert sorted(a) == sorted(b)
        for k in b:
            _same_tree(a[k], b[k])
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    elif b is None:
        assert a is None
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_generate_dataset_writes_the_jax_files(tmp_path):
    import h5py
    kw = dict(n_images=6, vocab_size=70, n_subgraphs=5, feat_dim=16,
              seed=3)
    p, j = generate_dataset(str(tmp_path / "p"), **kw), \
        j_generate(str(tmp_path / "j"), **kw)
    assert {k: v for k, v in p.items() if not isinstance(v, str)} == \
        {k: v for k, v in j.items() if not isinstance(v, str)}
    with open(p["input_json"]) as f, open(j["input_json"]) as g:
        assert json.load(f) == json.load(g)
    with h5py.File(p["input_label_h5"], "r") as a, \
            h5py.File(j["input_label_h5"], "r") as b:
        assert sorted(a) == sorted(b)
        for k in b:
            _same_tree(a[k][()], b[k][()])
    for d in ("sg_dir", "mask_dir"):
        names = sorted(os.listdir(j[d]))
        assert sorted(os.listdir(p[d])) == names and len(names) == 6
        for n in names:
            _same_tree(read_feat_npz(os.path.join(p[d], n)),
                       j_read(os.path.join(j[d], n)))
    for k in ("obj_name_path", "rel_name_path"):
        _same_tree(np.load(p[k]), np.load(j[k]))


def test_time_loader_times_four_ways(monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    out = time_loader.main(["--n_images", "10", "--n_subgraphs", "6",
                            "--batches", "1"])
    for k in ("npz_cpp", "npz_python", "packed_cpp", "packed_python"):
        assert out[k]["ms_per_batch"] > 0
    assert out["batch_images"] == 64
    assert capsys.readouterr().out.count("host CPU") == 4
