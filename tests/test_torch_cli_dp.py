"""Retrieval finetuning through the port's CLI on two gloo processes
(``--mesh_shape 2``, the ``ALPRO_COORDINATOR`` variables) against the same
CLI in one process; the one-process CLI is held to the JAX CLI by
``tests/test_torch_cli_train_ret.py``.

The fixtures of ``tests/fixtures.py`` (8 square clips of 4 frames,
``uniform`` sampling of 2, resized to the 32² crop, so that no draw of the
data path depends on which process loads a row), toy widths, fp32, dropout
and drop-path 0, global B = 2 (one row a process), 4 steps of AdamW. Held:
the logged losses within 1e-5; every parameter of the last deploy
checkpoint within 1e-5; the validation R@k rows (each process scores its
stripe of the videos, merged by ``all_gather_list``) equal; only rank 0
writes. Then both runs resume from their step-2 slot (the step-4 slot
removed) and finish again, equal again. The QA and pretraining CLIs on two
processes: ``tests/test_torch_cli_dp_tasks.py``.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import train_cli_fixtures as T
from alpro_tpu_torch.cli import run_video_retrieval
from alpro_tpu_torch.core.config import Config
from fixtures import write_video_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _two_processes(cfg, out, cli="run_video_retrieval", *argv, mesh_shape=("2",)):
    """``cli`` with ``--mesh_shape`` ``mesh_shape`` on two gloo processes
    joined by the ``ALPRO_COORDINATOR`` variables → each process's output."""
    cfg_path = out + ".json"
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               ALPRO_COORDINATOR=f"127.0.0.1:{port}", ALPRO_NUM_PROCESSES="2",
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", f"alpro_tpu_torch.cli.{cli}", "--config", cfg_path,
         "--device", "cpu", "--mesh_shape", *mesh_shape, "--output_dir", out, *argv],
        env=dict(env, ALPRO_PROCESS_ID=str(r)), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0].decode(errors="replace") for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r][-4000:]}"
    return logs


def _one_process(cfg, out, cli=run_video_retrieval):
    return cli.start_training(Config(dict(cfg, device="cpu", output_dir=out)))


def _drop_step4_slot(out):
    for slot in ("a", "b"):
        done = os.path.join(out, "restore", f"{slot}.done")
        if open(done).read().strip() == "4":
            os.remove(done)
            os.remove(os.path.join(out, "restore", f"{slot}.pt"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cli_dp"))
    ann, vid_dir, _ = write_video_dataset(root, n_videos=8, t=4, h=64, w=64)
    cfg = T.toy_cfg(root, train_datasets=[{"txt": ann, "img": vid_dir}],
                    val_datasets=[{"txt": ann, "img": vid_dir}], resize_size=32,
                    frm_sampling_strategy="uniform")
    cfg["e2e_weights_path"] = T.export_e2e(cfg, "retrieval", root, seed=3)
    dirs = {"one": os.path.join(root, "one"), "two": os.path.join(root, "two")}
    _one_process(cfg, dirs["one"])
    logs = _two_processes(cfg, dirs["two"])
    first = {k: T.port_deploy_params(d, 4) for k, d in dirs.items()}
    rows = {k: (T.by_key(T.metric_rows(d, "train_")), T.by_key(T.metric_rows(d, "val_")))
            for k, d in dirs.items()}
    for d in dirs.values():
        _drop_step4_slot(d)
    _one_process(cfg, dirs["one"])
    resumed_logs = _two_processes(cfg, dirs["two"])
    resumed = {k: T.port_deploy_params(d, 4) for k, d in dirs.items()}
    return dirs, first, rows, resumed, logs + resumed_logs


def _close(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), atol=T.PARAM_ATOL, rtol=0,
                                   err_msg=k)


def test_two_processes_match_one(runs):
    _, first, rows, _, _ = runs
    (train1, val1), (train2, val2) = rows["one"], rows["two"]
    assert sorted(train1) == ["train_loss", "train_vtc_loss", "train_vtm_loss"]
    assert train2.keys() == train1.keys() and all(len(v) == 4 for v in train1.values())
    for k, v in train1.items():
        np.testing.assert_allclose(train2[k], v, atol=T.LOSS_ATOL, rtol=0, err_msg=k)
    assert val2 == val1 and len(val1["val_t2v_r1"]) == 3
    _close(first["two"], first["one"])


def test_only_rank_zero_writes(runs):
    dirs, _, _, _, logs = runs
    out = dirs["two"]
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == ["model_step_2.pt", "model_step_4.pt"]
    assert os.path.exists(os.path.join(out, "log", "args.json"))
    with open(os.path.join(out, "log", "log.txt")) as f:
        text = f.read()
    assert "distributed: process 0 of 2" in text and "process 1 of 2" not in text
    assert "distributed: process 1 of 2" not in logs[1]  # rank 1 logs warnings only


def test_resume_on_two_processes_matches_one(runs):
    dirs, first, _, resumed, _ = runs
    with open(os.path.join(dirs["two"], "log", "log.txt")) as f:
        assert "resumed from step 2" in f.read()
    _close(resumed["two"], resumed["one"])
    # the resumed loader restarts its epoch, so steps 3-4 see other batches
    # than the first run's: a run from scratch would end where it ended
    assert any(not torch.equal(resumed["one"][k], first["one"][k]) for k in first["one"])

