"""A resumed retrieval finetuning run of the port's CLI against the JAX
CLI's resumed run.

Both CLIs train 4 micro-steps with ``gradient_accumulation_steps`` 2 and a
resume checkpoint every step (``save_steps_ratio`` 0.25; slots a, b, a, b),
on ``tests/train_cli_fixtures.py``'s toy config. Then the slot holding step
4 is removed on both sides, as a run cut while it wrote would leave it, and
``start_training`` runs again on the same ``output_dir``: both restore step
3, in the middle of an accumulation window (one micro-step's gradient
held), run step 4 and end. As in the JAX CLI, the resumed run starts its
data iterator afresh (epoch 0's order again; ROADMAP C3), so it is held to
the JAX CLI's resumed run, not to an uninterrupted one: the logged losses
of both runs within atol 1e-5, the validation rows equal, every parameter of
the resumed run's ``model_step_4`` within atol 1e-5.
"""

import os
import shutil

import train_cli_fixtures as T
from fixtures import write_video_dataset


def _drop_slot(out_dir, step):
    """Remove the resume slot whose marker holds ``step`` (data and marker)."""
    d = os.path.join(out_dir, "restore")
    for slot in ("a", "b"):
        marker = os.path.join(d, slot + ".done")
        if os.path.exists(marker) and int(open(marker).read()) == step:
            os.remove(marker)
            for name in (slot, slot + ".pt"):
                path = os.path.join(d, name)
                if os.path.isdir(path):
                    shutil.rmtree(path)
                elif os.path.exists(path):
                    os.remove(path)
            return slot
    raise AssertionError(f"no slot holds step {step} in {d}")


def test_resumed_run_matches_the_jax_resumed_run(tmp_path):
    root = str(tmp_path)
    ann, vid_dir, _ = write_video_dataset(root, n_videos=8, t=4, h=48, w=64)
    cfg = T.toy_cfg(root, train_datasets=[{"txt": ann, "img": vid_dir}],
                    val_datasets=[{"txt": ann, "img": vid_dir}], gradient_accumulation_steps=2,
                    save_steps_ratio=0.25, num_valid=1, min_valid_steps=100)
    cfg["e2e_weights_path"] = T.export_e2e(cfg, "retrieval", root, seed=4)
    dirs = T.run_both("run_video_retrieval", cfg, root, "resume")
    for out in dirs.values():
        assert _drop_slot(out, 4) == "b"
    assert T.run_both("run_video_retrieval", cfg, root, "resume") == dirs
    # the first run's 4 steps, then the resumed run's one (step 4), appended
    port = T.by_key(T.metric_rows(dirs["alpro_tpu_torch"], "train_"))
    assert all(len(v) == 5 for v in port.values())
    T.check_run(dirs, last_step=4, n_val_rows=2 * 5)
