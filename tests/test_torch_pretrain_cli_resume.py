"""A resumed pretraining run of the port's CLI against the JAX CLI's resumed
run.

Both CLIs pretrain on the first half of ``train_cli_fixtures.pretrain_cfg``'s
video set (2 steps, all four objectives, the teacher from an ALPRO-key
prompter ``.pt``, no val set) with a resume checkpoint every step
(``save_steps_ratio`` 0.5; slots a, b). Then the slot holding step 2 is
removed on both sides and ``start_training`` runs again on the same
``output_dir``: both rebuild the teacher and its banks, restore step 1 and
run step 2. The logged losses agree within atol 1e-5 and every parameter of
the resumed runs' ``model_step_2`` within atol 1e-5; the port's resumed run
restored step 1's slot bit for bit.
"""

import torch

import train_cli_fixtures as T
from test_torch_cli_train_resume import _drop_slot


def test_resumed_pretraining_matches_the_jax_resumed_run(tmp_path):
    from alpro_tpu_torch.checkpoint import restore

    root = str(tmp_path)
    cfg = T.pretrain_cfg(root, mixed=False, data_ratio=0.5, save_steps_ratio=0.5,
                         num_valid=1, min_valid_steps=1, val_datasets=[])
    cfg["teacher_weights_path"] = T.export_e2e(cfg, "prompter", root, seed=7)
    cfg["e2e_weights_path"] = T.export_e2e(cfg, "pretrain", root, seed=3)
    dirs = T.run_both("run_pretrain", cfg, root, "resume")
    for out in dirs.values():
        assert _drop_slot(out, 2) == "b"
    slot = torch.load(f"{dirs['alpro_tpu_torch']}/restore/a.pt", weights_only=True)
    restored = []
    real = restore.TrainingRestorer.restore

    def recording(restorer, state):
        out = real(restorer, state)
        restored.append(restore.snapshot(state))
        return out

    restore.TrainingRestorer.restore = recording
    try:
        assert T.run_both("run_pretrain", cfg, root, "resume") == dirs
    finally:
        restore.TrainingRestorer.restore = real
    (snap,) = restored
    assert snap["step"] == 1 == slot["step"]
    for part in ("params", "mu", "nu"):
        for k, v in slot[part].items():
            assert torch.equal(snap[part][k], v), (part, k)
    port = T.by_key(T.metric_rows(dirs["alpro_tpu_torch"], "train_"))
    assert all(len(v) == 3 for v in port.values())  # 2 steps, then the resumed step 2
    T.check_losses(dirs)
    T.check_params(T.jax_deploy_params(dirs["alpro_tpu"], 2),
                   T.port_deploy_params(dirs["alpro_tpu_torch"], 2))
