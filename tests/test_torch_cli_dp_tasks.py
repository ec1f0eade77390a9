"""The QA and pretraining CLIs on two gloo processes (``--mesh_shape 2``,
the ``ALPRO_COORDINATOR`` variables), as ``tests/test_torch_cli_dp.py``
runs the retrieval CLI. Open-ended QA (square fixture clips, ``uniform``
sampling, resized to the 32² crop; 2 clips a question, accumulation over 2)
on two processes equals one process: losses, accuracies and validation rows
within 1e-5, the last parameters within 1e-5. The prompter and pretraining
CLIs run on two processes (their RandAugment and masking draw per process,
so no one-process twin exists) and write one finite loss row a step.
"""

import json
import os

import numpy as np

import train_cli_fixtures as T
from alpro_tpu_torch.cli import run_video_qa
from fixtures import write_qa_dataset
from test_torch_cli_dp import _close, _one_process, _two_processes

def test_qa_on_two_processes_matches_one(tmp_path):
    """Open-ended QA with ``train_n_clips`` 2 and accumulation over 2 (4
    micro-steps, 2 updates): the 2-process run's losses, accuracies,
    validation rows and last parameters as the one-process run's."""
    root = str(tmp_path)
    ann, vid_dir, _, ans2label = write_qa_dataset(root, n=8, t=4, h=64, w=64)
    a2l = os.path.join(root, "ans2label.json")
    with open(a2l, "w") as f:
        json.dump(ans2label, f)
    cfg = T.toy_cfg(root, train_datasets=[{"txt": ann, "img": vid_dir}],
                    val_datasets=[{"txt": ann, "img": vid_dir}], task="msvd_qa",
                    ans2label_path=a2l, num_labels=len(ans2label), cls_hidden_scale=2,
                    train_n_clips=2, inference_n_clips=1, score_agg_func="mean",
                    gradient_accumulation_steps=2, resize_size=32,
                    frm_sampling_strategy="uniform")
    cfg["e2e_weights_path"] = T.export_e2e(cfg, "qa", root, seed=5)
    one, two = os.path.join(root, "one"), os.path.join(root, "two")
    state = _one_process(cfg, one, run_video_qa)
    assert state.step == 4 and state.opt_state.count == 2
    _two_processes(cfg, two, "run_video_qa")
    for prefix in ("train_", "val_"):
        want, got = (T.by_key(T.metric_rows(d, prefix)) for d in (one, two))
        assert got.keys() == want.keys() and want
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, atol=T.LOSS_ATOL, rtol=0, err_msg=k)
    _close(T.port_deploy_params(two, 4), T.port_deploy_params(one, 4))


def test_pretraining_chain_on_two_processes(tmp_path):
    """The prompter, then pretraining with it as the teacher (VTC + VTM +
    MLM + MPM over the mixed video and image loaders), each with
    ``--mesh_shape 2``: both finish, rank 0 writes the deploy checkpoints
    and one finite row of each loss a step."""
    root = str(tmp_path)
    teacher = os.path.join(root, "prompter")
    _two_processes(T.prompter_cfg(root), teacher, "run_prompter")
    out = os.path.join(root, "pretrain")
    _two_processes(T.pretrain_cfg(root), out, "run_pretrain", "--teacher_weights_path",
                   os.path.join(teacher, "ckpt", "model_step_4.pt"))
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == ["model_step_4.pt", "model_step_8.pt"]
    rows = T.by_key(T.metric_rows(out, "train_"))
    assert sorted(rows) == ["train_itc_loss", "train_itm_loss", "train_loss", "train_mlm_loss",
                            "train_mpm_kept", "train_mpm_loss"]
    assert all(0 <= v <= 2 for v in rows["train_mpm_kept"])
    assert all(len(v) == 8 and np.isfinite(v).all() for v in rows.values())
