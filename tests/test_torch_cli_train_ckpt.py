"""The port's finetuning CLI as a user drives it: its deploy checkpoint read
by the JAX package, ``--debug``, and ``main`` from the command line.

On ``tests/train_cli_fixtures.py``'s toy config (fp32, B = 2, 4 steps):
the port's ``ckpt/model_step_4.pt`` is an ALPRO-key ``.pt`` that the JAX
CLI reads through ``load_reference_checkpoint`` (``inference_model_ckpt``)
to the scores that the port's ``--inference_model_step 4`` gives, within
5e-4 (the parity gate's scores atol), and to the same metrics; ``--debug``
validates every step and stops after four; ``python -m
alpro_tpu_torch.cli.run_video_retrieval --config ... --device cpu`` trains
in a fresh interpreter; a second run on the same ``output_dir`` resumes.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import train_cli_fixtures as T
from alpro_tpu.core.config import Config as JaxConfig
from alpro_tpu_torch.core.config import Config
from fixtures import write_video_dataset

REPO = Path(__file__).resolve().parent.parent
SCORE_ATOL = 5e-4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ckpt"))
    ann, vid_dir, _ = write_video_dataset(root, n_videos=8, t=4, h=48, w=64)
    cfg = T.toy_cfg(root, train_datasets=[{"txt": ann, "img": vid_dir}],
                    val_datasets=[{"txt": ann, "img": vid_dir}], device="cpu")
    cfg["e2e_weights_path"] = T.export_e2e(cfg, "retrieval", root, seed=8)
    return root, cfg


def test_jax_reads_the_ports_deploy_checkpoint(setup):
    from alpro_tpu.cli import run_video_retrieval as jret
    from alpro_tpu_torch.cli import run_video_retrieval as pret

    root, cfg = setup
    out = os.path.join(root, "train")
    assert pret.start_training(Config(dict(cfg, output_dir=out))).step == 4
    icfg = dict(cfg, do_inference=True)
    got = pret.start_inference(Config(dict(icfg, output_dir=out, inference_model_step="4")))
    jout = os.path.join(root, "jax_infer")
    want = jret.start_inference(JaxConfig(dict(
        {k: v for k, v in icfg.items() if k != "device"}, output_dir=jout,
        inference_model_ckpt=os.path.join(out, "ckpt", "model_step_4.pt"))))
    port_rows = json.loads(Path(out, "results.json").read_text())["results"]
    jax_rows = json.loads(Path(jout, "results.json").read_text())["results"]
    assert [(r["vid_id"], r["txt_id"]) for r in port_rows] == \
        [(r["vid_id"], r["txt_id"]) for r in jax_rows]
    np.testing.assert_allclose([r["score"] for r in port_rows], [r["score"] for r in jax_rows],
                               atol=SCORE_ATOL, rtol=0)
    assert got == want


def test_debug_stops_after_four_steps(setup):
    """8 steps asked for; ``debug`` validates (5 videos) and saves after
    every step and stops after the fourth."""
    from alpro_tpu_torch.cli import run_video_retrieval as pret

    root, cfg = setup
    out = os.path.join(root, "debug")
    state = pret.start_training(Config(dict(cfg, output_dir=out, num_train_epochs=2,
                                            debug=True)))
    assert state.step == 4
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == [f"model_step_{i}.pt"
                                                             for i in range(1, 5)]
    assert len(T.by_key(T.metric_rows(out, "val_"))["val_t2v_r1"]) == 5  # 4 + final


def test_main_trains_from_the_command_line(setup, tmp_path):
    _, cfg = setup
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({k: v for k, v in cfg.items() if k != "device"}))
    out = tmp_path / "out"
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    run = subprocess.run(
        [sys.executable, "-m", "alpro_tpu_torch.cli.run_video_retrieval", "--config", str(path),
         "--device", "cpu", "--output_dir", str(out), "--num_valid", "1"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert sorted(os.listdir(out / "ckpt")) == ["model_step_4.pt"]
    args = json.loads((out / "log" / "args.json").read_text())
    assert args["num_valid"] == 1 and args["device"] == "cpu" and args["do_inference"] is False


def test_resume_from_restorer(setup):
    """``tests/test_cli_e2e.py::test_resume_from_restorer`` on the port: a
    second ``start_training`` on the same ``output_dir`` resumes from the
    newest slot (step 4, the end) instead of starting again from 0."""
    from alpro_tpu_torch.cli import run_video_retrieval as pret

    root, cfg = setup
    run = Config(dict(cfg, output_dir=os.path.join(root, "resume")))
    assert pret.start_training(run).step == 4
    assert pret.start_training(Config(run)).step == 4
    losses = T.by_key(T.metric_rows(run.output_dir, "train_"))["train_loss"]
    assert len(losses) == 4  # no step ran again
