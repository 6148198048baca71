"""The port's binding to the host library (``ops/native.py``) against the JAX
package's (``subgc_tpu/ops/native.py``), which builds the same C++ source:

* the PTB tokenizer, pairwise CIDEr and mBLEU-4 bitwise equal to JAX's, and
  within rtol 1e-10 of the port's Python paths (``eval/pairwise.py``'s
  ``*_plain``); the embedded-separator case of ``tests/test_native.py``;
* the C++ sampler equal to JAX's for the same seeds (also with more rows
  than sentences), declining short matrices as JAX's does;
* the port's default ``TrainLoader`` (C++ sampler) equal to JAX's default
  batch for batch, across an epoch wrap; ``SUBGC_NATIVE_SAMPLER=0`` and
  ``native_sampler=False`` select the Python sampler in both;
* a build with a missing or failing compiler raises, with nothing to fall
  back on; processes that build into one fresh directory at once agree;
* the module fixture waits for a whole JAX library (``tests/_native_lib.py``)
  and survives a failed first load: test workers that start at once in a
  fresh tree race on the JAX package's in-place build.
"""
import ctypes
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import subgc_tpu.config as JC
import subgc_tpu.ops.native as JN
from subgc_tpu.data.dataset import TrainLoader as JTrainLoader
from subgc_tpu.data.dataset import sample_pos_neg as j_sample_pos_neg
from subgc_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
from subgc_tpu_torch.data.dataset import TrainLoader, sample_pos_neg
from subgc_tpu_torch.eval import pairwise as PP
from subgc_tpu_torch.ops import _build
from subgc_tpu_torch.ops import native as N

from ._native_lib import wait_for_native
from .test_torch_port_metrics import _sentences
from .test_torch_port_train_cli import _dcfg, data  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    """The JAX side must run its C++ cores, not its Python fallbacks.  Other
    test processes may be building its library in place right now, so wait
    for a whole one first; a library that truly cannot build still fails
    here."""
    wait_for_native(JN)
    assert JN.available(), "the JAX package's host library did not build"


class _FakeNative:
    """A library loader with ``subgc_tpu.ops.native``'s memory: one load
    attempt, remembered until ``_tried`` is cleared."""

    def __init__(self, d):
        self._NATIVE_DIR = str(d)
        self._SO_PATH = str(d / "libsubgc_native.so")
        self._lib, self._tried = None, False
        (d / "subgc_native.cpp").write_text("// source\n")
        os.utime(d / "subgc_native.cpp", (0, 0))     # older than any library

    def available(self):
        if self._lib is None and not self._tried:
            self._tried = True
            try:
                self._lib = ctypes.CDLL(self._SO_PATH)
            except OSError:
                pass
        return self._lib is not None


def test_fixture_recovers_the_jax_library_after_a_failed_first_load(
        monkeypatch):
    """The race's aftermath: the library is whole on disk, but this process
    met it half-written and remembers the failure."""
    monkeypatch.setattr(JN, "_lib", None)
    monkeypatch.setattr(JN, "_tried", True)
    assert not JN.available()
    wait_for_native(JN)
    assert JN.available()
    sents = ["a dog in the park", "a cat on a mat", "a dog on a mat"]
    _bits(JN.mutual_bleu4(sents), PP.mutual_bleu4(sents))


def test_wait_outlasts_a_library_still_being_written(tmp_path):
    """Another process is still writing the library when this one looks:
    the first load fails, the wait sees the whole library once it lands."""
    fake = _FakeNative(tmp_path)
    whole = open(JN._SO_PATH, "rb").read()
    with open(fake._SO_PATH, "wb") as f:
        f.write(whole[:100])                        # half-written
    assert not fake.available() and fake._tried

    def finish():
        time.sleep(0.5)
        tmp = fake._SO_PATH + ".tmp"
        with open(tmp, "wb") as f:
            f.write(whole)
        os.replace(tmp, fake._SO_PATH)

    writer = threading.Thread(target=finish)
    writer.start()
    wait_for_native(fake, timeout=30, poll=0.05)
    writer.join()
    assert fake.available()
    assert fake._lib.subgc_mutual_bleu4 is not None


def test_wait_fails_loudly_on_a_library_that_never_loads(tmp_path):
    fake = _FakeNative(tmp_path)
    shutil.copyfile(__file__, fake._SO_PATH)        # not a shared library
    with pytest.raises(AssertionError, match="does not load"):
        wait_for_native(fake, timeout=0.3, poll=0.05)
    assert not fake.available()


def _bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scorer_cores_bitwise_equal_jax_and_near_plain(seed):
    raw = _sentences(14, seed) + ["", "A man's dog, running!",
                                  "It's a (big) dog -- really."]
    toks = PP.ptb_tokenize_batch(raw)
    assert toks == JN.ptb_tokenize_batch(raw)
    assert toks == PP.ptb_tokenize_batch_plain(raw)
    assert PP.ptb_tokenize_batch(raw, lowercase=False) == \
        JN.ptb_tokenize_batch(raw, lowercase=False)
    docs = [toks[i:i + 3] for i in range(0, 12, 3)]
    hyps, refs = toks[:5], toks[5:12] + ["zebra"]
    for sigma in (6.0, 3.0):
        got = PP.pairwise_cider_matrix(docs, hyps, refs, sigma=sigma)
        _bits(got, JN.pairwise_cider_matrix(docs, hyps, refs, sigma=sigma))
        np.testing.assert_allclose(
            got, PP.pairwise_cider_matrix_plain(docs, hyps, refs,
                                                sigma=sigma),
            rtol=1e-10, atol=1e-12)
    got = PP.mutual_bleu4(toks[:6])
    _bits(got, JN.mutual_bleu4(toks[:6]))
    np.testing.assert_allclose(got, PP.mutual_bleu4_plain(toks[:6]),
                               rtol=1e-10)


def test_embedded_separators_cannot_desync_the_blobs():
    """tests/test_native.py's case: '\\n' and '\\t' inside captions are
    collapsed before they ride the line / tab framed blobs, which leaves
    the Python paths' results unchanged."""
    docs = [["a man riding a\nhorse", "a dog in\tthe park"],
            ["a red ball on grass"]]
    hyps = ["a man riding\na horse", "a dog in\tthe park"]
    refs = ["a man on a horse", "a\nred ball", "a dog in the park"]
    got = PP.pairwise_cider_matrix(docs, hyps, refs)
    assert got.shape == (2, 3)
    _bits(got, JN.pairwise_cider_matrix(docs, hyps, refs))
    np.testing.assert_allclose(
        got, PP.pairwise_cider_matrix_plain(docs, hyps, refs), rtol=1e-9)
    sents = ["a dog in\tthe park", "a dog in the park",
             "a dog in the park today"]
    mb = PP.mutual_bleu4(sents)
    _bits(mb, JN.mutual_bleu4(sents))
    assert mb[0] > 0.5, mb
    raw = ["two\nlines here", "a\ttab"]
    assert PP.ptb_tokenize_batch(raw) == JN.ptb_tokenize_batch(raw) == \
        ["two lines here", "a tab"]


def _iou(rng, rows, cols, frac_pos):
    m = rng.rand(rows, cols).astype(np.float32) * 0.6
    m[rng.rand(rows, cols) < frac_pos] += 0.5
    return m


@pytest.mark.parametrize("rows,cols,frac,half", [
    (5, 45, 0.2, 4),      # weighted positives, negatives without replacement
    (7, 45, 0.2, 4),      # extra rows: the weights' column sums cover them
    (5, 12, 0.05, 6),     # short positives (GT pad), short negatives
    (5, 9, 0.9, 3),       # almost no negatives: the <= thres pool
])
def test_cpp_sampler_equals_jax(rows, cols, frac, half):
    rng = np.random.RandomState(rows * 100 + cols)
    for seed in (0, 1, 12345, (1 << 31) - 1):
        m = _iou(rng, rows, cols, frac)
        got = N.sample_pos_neg_native(m, 0.5, half, 5, seed)
        want = JN.sample_pos_neg_native(m, 0.5, half, 5, seed)
        assert got is not None
        _bits(got, want)
        assert got.min() >= 0 and got.max() < cols
        # the plain version: the same branches from a numpy stream
        plain = sample_pos_neg(m.copy(), 0.5, half, 5,
                               np.random.RandomState(seed))
        _bits(plain, j_sample_pos_neg(m.copy(), 0.5, half, 5,
                                      np.random.RandomState(seed)))


def test_cpp_sampler_declines_what_jax_declines():
    short = np.random.RandomState(0).rand(3, 20).astype(np.float32)
    assert N.sample_pos_neg_native(short, 0.5, 2, 5, 0) is None
    assert JN.sample_pos_neg_native(short, 0.5, 2, 5, 0) is None
    no_cols = np.ones((5, 5), np.float32)
    assert N.sample_pos_neg_native(no_cols, 0.5, 2, 5, 0) is None
    assert JN.sample_pos_neg_native(no_cols, 0.5, 2, 5, 0) is None


def _loaders(man, native, gt=False):
    kw = dict(batch_size=4)
    jl = JTrainLoader(JC.ModelConfig(use_gt_subg=gt), JC.TrainConfig(**kw),
                      _dcfg(man, JC.DataConfig), seed=11,
                      native_sampler=native)
    pl = TrainLoader(ModelConfig(use_gt_subg=gt), TrainConfig(**kw),
                     _dcfg(man, DataConfig), seed=11, native_sampler=native)
    return jl, pl


def _same_batches(jl, pl, splits=("train", "train", "train", "val")):
    for split in splits:
        jb, ji, jw = jl.get_batch(split)
        pb, pi, pw = pl.get_batch(split)
        assert pi == ji and pw == jw
        for name in ("labels", "masks", "sub_obj_ind", "sub_att_mask",
                     "img_ix"):
            _bits(getattr(pb, name), getattr(jb, name))
        for a, b in zip(pb.graph, jb.graph):
            _bits(a, b)


def test_default_train_loader_equals_jax_default(data):  # noqa: F811
    """Both defaults draw with the C++ sampler, seeded from the loaders'
    numpy streams: equal batches, one across the epoch wrap."""
    _, man = data
    jl, pl = _loaders(man, native=True)
    assert jl.native_sampler and pl.native_sampler
    _same_batches(jl, pl)


def test_python_sampler_is_chosen_by_flag_or_environment(data,  # noqa: F811
                                                         monkeypatch):
    _, man = data
    jl, pl = _loaders(man, native=False)
    assert not pl.native_sampler
    _same_batches(jl, pl, ("train", "train"))
    monkeypatch.setenv("SUBGC_NATIVE_SAMPLER", "0")
    jl, pl = _loaders(man, native=True)
    assert not jl.native_sampler and not pl.native_sampler
    _same_batches(jl, pl, ("train",))
    # the two samplers draw differently: the flag does choose
    monkeypatch.delenv("SUBGC_NATIVE_SAMPLER")
    _, native = _loaders(man, native=True)
    _, plain = _loaders(man, native=False)
    assert not np.array_equal(native.get_batch()[0].sub_obj_ind,
                              plain.get_batch()[0].sub_obj_ind)


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """An empty build directory and no library loaded yet."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "BUILD_INFO", {})
    monkeypatch.setattr(N, "_lib", None)
    return tmp_path


@pytest.mark.parametrize("cxx,match", [
    ("no-such-compiler-x", "not found"),
    ("false", "building subgc_native failed")])
def test_failed_build_raises_and_nothing_falls_back(fresh_build, monkeypatch,
                                                    cxx, match):
    monkeypatch.setenv("CXX", cxx)
    with pytest.raises(RuntimeError, match=match):
        N.library()
    with pytest.raises(RuntimeError, match=match):
        PP.mutual_bleu4(["a dog", "a cat"])
    with pytest.raises(RuntimeError, match=match):
        N.sample_pos_neg_native(np.ones((5, 9), np.float32), 0.5, 2, 5, 0)
    assert N._lib is None
    assert not list(fresh_build.iterdir())        # no partial library left


BUILD_IN = """
import sys
from subgc_tpu_torch.ops import _build
_build.BUILD_DIR = sys.argv[1]
print(_build.host_library_path("subgc_native"))
"""


def test_processes_building_at_once_agree(fresh_build):
    """Four processes build into one fresh directory at once (the test
    workers' case): each gets a complete library at the same path, and no
    temporary file is left."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_IN,
                               str(fresh_build)], cwd=root,
                              stdout=subprocess.PIPE, text=True)
             for _ in range(4)]
    paths = [p.communicate(timeout=120)[0].strip() for p in procs]
    assert [p.returncode for p in procs] == [0] * 4
    assert len(set(paths)) == 1
    assert os.listdir(fresh_build) == [os.path.basename(paths[0])]
    lib = _build.load_host("subgc_native")
    assert lib._name == paths[0]
