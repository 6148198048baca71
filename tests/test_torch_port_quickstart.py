"""The port's hermetic walkthrough (``python -m
subgc_tpu_torch.cli.quickstart``) runs to its end on the CPU with
``--device cpu`` in a given workdir: 10 train iterations of the Sub_GC_Kar
preset, decode + language eval at oracle 3, the diversity report and the
consensus rerank; and without a card it raises rather than falling back.

The walkthrough trains and decodes the preset at its full widths: 17 s on
the CPU with every core, 47 s on one thread, so its run is marked
``slow`` (``chip_smoke.py`` phase 27c runs it on the card in every run).
"""
import os

import numpy as np
import pytest

from subgc_tpu_torch.cli import quickstart


@pytest.mark.slow
def test_quickstart_on_the_cpu(tmp_path, capsys):
    res = quickstart.main([str(tmp_path), "--device", "cpu"])
    run = tmp_path / "run"
    for name in ("model.npz", "infos.json", "captions_10.npy",
                 "all_scores_10_3-subgraph.npy"):
        assert (run / name).exists(), name
    assert os.path.exists(tmp_path / "data" / "talk_label.npz")
    preds = np.load(res["captions_path"], allow_pickle=True).tolist()
    assert len(preds) == 2 and all(p["caption"] for p in preds)
    assert all(0 <= v <= 1 for v in res["diversity"]["distinct"])
    assert sorted(res["rerank_ind"]) == sorted(p["image_id"] for p in preds)
    assert all(sorted(v) == [0, 1, 2] for v in res["rerank_ind"].values())
    assert "--- done" in capsys.readouterr().out


def test_quickstart_refuses_to_fall_back_to_the_cpu(tmp_path, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quickstart.main([str(tmp_path)])
    assert not os.listdir(tmp_path)
