"""Multi-choice QA finetuning through the port's CLI against the JAX CLI.

TGIF-action style rows (``tests/fixtures.py``: 6 questions, 3 options
each, the answer an option index), ``task='action'``: both CLIs force
``num_labels`` 1 and score question + option rows, B = 2 questions (6
rows) a step, 3 steps validated at each, at ``tests/train_cli_fixtures.py``'s toy config.
Held as for open-ended QA: losses and accuracies within atol 1e-5, the
validation accuracy equal, every parameter of ``model_step_3`` within atol
1e-5 but the output bias ``classifier.2.bias``: it adds the same value to
every option's logit, so its exact gradient is 0 (the softmax over options
ignores a shift); what each side computes there is rounding, which AdamW
divides by its own size, so its updates are rounding too.
"""

import train_cli_fixtures as T
from fixtures import write_multichoice_qa_dataset


def test_multi_choice_qa_training_matches_jax(tmp_path):
    root = str(tmp_path)
    ann, vid_dir, _ = write_multichoice_qa_dataset(root, n=6, t=2, h=48, w=64, n_options=3)
    cfg = T.toy_cfg(root, train_datasets=[{"txt": ann, "img": vid_dir}],
                    val_datasets=[{"txt": ann, "img": vid_dir}], task="action", n_options=3,
                    num_labels=1, cls_hidden_scale=2, max_txt_len=40, train_n_clips=1,
                    inference_n_clips=1, score_agg_func="mean", val_batch_size=3,
                    inference_batch_size=3, num_valid=3)
    cfg["e2e_weights_path"] = T.export_e2e(cfg, "qa", root, seed=6)
    cfg["num_labels"] = 1500  # the CLIs force 1 for a multi-choice task
    dirs = T.run_both("run_video_qa", cfg, root, "mc")
    T.check_run(dirs, last_step=3, n_val_rows=3, skip=("classifier.2.bias",))
