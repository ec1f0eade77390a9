"""Retrieval finetuning through the port's CLI with ``--mesh_shape 1 2`` on
two gloo processes (the ``ALPRO_COORDINATOR`` variables): the model's
sequence-parallel layout, each process attending its half of the frames'
queries in every train step, against the same CLI in one process, as
``tests/test_torch_cli_dp.py`` holds ``--mesh_shape 2``.

The fixtures of ``tests/fixtures.py`` (8 square clips of 4 frames,
``uniform`` sampling of all 4, resized to the 32² crop), toy widths, fp32,
dropout and drop-path 0, B = 2 on both processes (dp 1), 4 steps of AdamW.
Held: the logged losses within 1e-5, every parameter of the last deploy
checkpoint within 1e-5, the validation R@k rows (unsplit, each process
scoring its stripe of the videos) equal; the layout logged; only rank 0
writes.
"""

import os

import numpy as np
import pytest

import train_cli_fixtures as T
from fixtures import write_video_dataset
from test_torch_cli_dp import _close, _one_process, _two_processes


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cli_sp"))
    ann, vid_dir, _ = write_video_dataset(root, n_videos=8, t=4, h=64, w=64)
    cfg = T.toy_cfg(root, train_datasets=[{"txt": ann, "img": vid_dir}],
                    val_datasets=[{"txt": ann, "img": vid_dir}], resize_size=32, num_frm=4,
                    frm_sampling_strategy="uniform")
    cfg["e2e_weights_path"] = T.export_e2e(cfg, "retrieval", root, seed=3)
    dirs = {"one": os.path.join(root, "one"), "sp": os.path.join(root, "sp")}
    _one_process(cfg, dirs["one"])
    logs = _two_processes(cfg, dirs["sp"], mesh_shape=("1", "2"))
    return dirs, logs


def test_sp_on_two_processes_matches_one(runs):
    dirs, _ = runs
    (train1, val1), (train2, val2) = (
        (T.by_key(T.metric_rows(d, "train_")), T.by_key(T.metric_rows(d, "val_")))
        for d in (dirs["one"], dirs["sp"]))
    assert sorted(train1) == ["train_loss", "train_vtc_loss", "train_vtm_loss"]
    assert train2.keys() == train1.keys() and all(len(v) == 4 for v in train1.values())
    for k, v in train1.items():
        np.testing.assert_allclose(train2[k], v, atol=T.LOSS_ATOL, rtol=0, err_msg=k)
    assert val2 == val1 and len(val1["val_t2v_r1"]) == 3
    _close(T.port_deploy_params(dirs["sp"], 4), T.port_deploy_params(dirs["one"], 4))


def test_sp_layout_is_logged_and_only_rank_zero_writes(runs):
    dirs, logs = runs
    out = dirs["sp"]
    with open(os.path.join(out, "log", "log.txt")) as f:
        text = f.read()
    assert "mesh (dp, sp) = (1, 2): each train step splits the frames" in text
    assert "distributed: process 0 of 2" in text and "process 1 of 2" not in text
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == ["model_step_2.pt", "model_step_4.pt"]
    assert "distributed: process 1 of 2" not in logs[1]
