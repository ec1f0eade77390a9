"""Open-ended QA finetuning through the port's CLI against the JAX CLI.

MSVD-QA style rows (``tests/fixtures.py``: 8 questions on clips of 4
frames, 4 answers), ``train_n_clips`` 2 (each question's 4 sampled frames
as 2 clips of 2, forwarded in turn, only the last clip's loss
backpropagated) and ``gradient_accumulation_steps`` 2, as
``configs/msrvtt_qa.json`` accumulates: both packages' ``start_training``
at ``tests/train_cli_fixtures.py``'s toy config (fp32, dropout 0, B = 2, 4
micro-steps of AdamW at lr 1e-4 from one ALPRO-key ``.pt``). Held: the
schedule built over the same number of optimizer steps (2) with the same
arguments, and as many updates applied; the logged losses and accuracies
within atol 1e-5, the validation accuracies equal, every parameter of
``model_step_4`` within atol 1e-5.
"""

import json
import os

import alpro_tpu.cli.common as jcommon
import alpro_tpu_torch.cli.common as pcommon
import train_cli_fixtures as T
from fixtures import write_qa_dataset


def test_open_ended_qa_training_matches_jax(tmp_path, monkeypatch):
    root = str(tmp_path)
    ann, vid_dir, _, ans2label = write_qa_dataset(root, n=8, t=4, h=48, w=64)
    a2l = os.path.join(root, "ans2label.json")
    with open(a2l, "w") as f:
        json.dump(ans2label, f)
    cfg = T.toy_cfg(root, train_datasets=[{"txt": ann, "img": vid_dir}],
                    val_datasets=[{"txt": ann, "img": vid_dir}], task="msvd_qa",
                    ans2label_path=a2l, num_labels=len(ans2label), cls_hidden_scale=2,
                    train_n_clips=2, inference_n_clips=1, score_agg_func="mean",
                    gradient_accumulation_steps=2)
    cfg["e2e_weights_path"] = T.export_e2e(cfg, "qa", root, seed=5)
    schedules = {}
    for name, mod in (("alpro_tpu", jcommon), ("alpro_tpu_torch", pcommon)):
        def record(*args, _name=name, _build=mod.get_lr_schedule, **kw):
            schedules[_name] = (args, kw)
            return _build(*args, **kw)
        monkeypatch.setattr(mod, "get_lr_schedule", record)
    states = {}
    dirs = T.run_both("run_video_qa", cfg, root, "qa", states)
    assert schedules["alpro_tpu_torch"] == schedules["alpro_tpu"]
    assert schedules["alpro_tpu"][0][2] == 2  # 4 micro-steps, 2 optimizer steps
    assert states["alpro_tpu_torch"].opt_state.count == \
        int(states["alpro_tpu"].opt_state.gradient_step) == 2
    keys = {k for k, _ in T.metric_rows(dirs["alpro_tpu_torch"], "train_")}
    assert keys == {"train_loss", "train_acc", "train_loss_all_clips", "train_acc_all_clips"}
    T.check_run(dirs, last_step=4, n_val_rows=3)
