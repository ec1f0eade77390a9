"""The port's pretraining step against the benchmark's plain fp32 reference
(``perfbench/reference/pretrain.py``), on the CPU at a tiny size with seeded
random weights, and the step over two gloo processes against one process
on the same global batch.

The tiny ALPRO of ``perfbench/tests/tiny.py`` (2 video blocks and 2 BERT
layers of width 64, 2 frames of 32², dropout and drop-path 0.1) with both
pretraining heads over 6 entities, in fp32; the frozen teacher from another
sub-seed; both prompt banks built by ``cli/run_pretrain.py::
setup_prompt_banks`` over the pretraining cell's entity file. One
micro-batch of 4 clips from that cell's pool (the port's
``PretrainCollator``: MLM masks, MPM erase views), VTM's negatives in 2
blocks. The reference draws
its dropout and drop-path masks and its hard negatives from the step's
generator as the program does: the picks must be the program's, each
objective's loss within 2e-5, every gradient within 1e-4 of the whole
gradient's largest entry (fp32 summation order differs between the two),
the soft labels within 1e-4 (the logits are over a temperature of 0.005)
and their ignore masks equal, the banks within 1e-5. The teacher's weights
are drawn at ten times the student's std: at 0.02 every bank row is nearly
the same vector, every soft label nearly uniform and every row ignored,
whatever the temperature within its clamp; at ten times it, and a
temperature of 0.005, the 4 rows are kept and MPM's loss and gradients are
exercised."""

import os
import sys
import tempfile

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import torch_dist_worker as W  # noqa: E402
from perfbench.drivers import pretrain_loop as driver  # noqa: E402
from perfbench.lib import port  # noqa: E402
from perfbench.lib.recorder import Recorder  # noqa: E402
from perfbench.lib.weights import make_weights, sub_seed  # noqa: E402
from perfbench.reference import pretrain as ref  # noqa: E402
from perfbench.reference.alpro import Net  # noqa: E402
from perfbench.reference.objectives import gradients, step_generator  # noqa: E402
from perfbench.tests.tiny import ctx_for, tiny_cell  # noqa: E402

SEED, LOOP_SEED, TEMP = 2 ** 34 + 5, 11, 0.005


class GradTap:
    """The port's optimizer interface: keeps the step's gradients by name."""

    def init(self, named_params):
        self.names = list(named_params)

    def update(self, state, params, grads):
        self.grads = {n: g.detach().clone() for n, g in zip(self.names, grads)}
        return True


@pytest.fixture(scope="module")
def setup():
    from alpro_tpu_torch.cli import common, run_pretrain
    from alpro_tpu_torch.core.config import Config

    cell = tiny_cell("pretrain_t4_b64", "alpro_pretrain", "pretrain_webvid_cc3m",
                     pool_batches=1)
    cfg = cell.config
    cfg.update(compute_dtype="float32", train_batch_size=4, vtm_negative_blocks=2,
               num_entities=6)
    cfg["assumed"] = dict(cfg["assumed"], teacher_temp=TEMP)
    ctx = ctx_for(cell, seed=SEED)
    ents = driver.entities(cfg["num_entities"])
    tmp = tempfile.TemporaryDirectory()
    run_cfg = Config(dict(cfg, **driver._write_inputs(cfg, ents, tmp.name), seed=LOOP_SEED,
                          device="cpu", output_dir=None, teacher_weights_path=None,
                          n_workers=0))
    tok = driver.tokenizer(ents)
    model = common.build_model_from_cfg(run_cfg, "pretrain")
    weights = make_weights(port.layout(model), sub_seed(SEED, 40), ctx.device)
    port.load_weights(model, weights)
    teacher = run_pretrain.build_teacher(run_cfg)
    t_weights = make_weights(port.layout(teacher), sub_seed(SEED, 41), ctx.device)
    for name in t_weights:      # ten times the std: soft labels that are not uniform
        if name != "temp" and "norm" not in name.lower():
            t_weights[name] = t_weights[name] * 10.0
    t_weights["temp"].fill_(TEMP)
    port.load_weights(teacher, t_weights)
    banks = run_pretrain.setup_prompt_banks(run_cfg, teacher, tok)
    pool = driver.make_pools(ctx, tok)["webvid2m"].batches[0]
    batch = {k: torch.from_numpy(v) for k, v in pool.items()
             if isinstance(v, np.ndarray) and k != "context_visual_inputs"}
    yield dict(cfg=cfg, model=model, weights=weights, teacher=teacher, t_weights=t_weights,
               banks=banks, batch=batch, prompts=driver._prompts(cfg, tok, ents, ctx.device))
    tmp.cleanup()


@pytest.fixture(scope="module")
def stepped(setup):
    """One program step (gradients tapped, the picks and soft labels
    recorded) and the reference's forward and gradients on its batch."""
    from alpro_tpu_torch.train.state import TrainState
    from alpro_tpu_torch.train.step import make_pretrain_train_step

    s = setup
    tap = GradTap()
    step = make_pretrain_train_step(s["model"], tap, num_local_blocks=2, teacher=s["teacher"],
                                    banks=s["banks"])
    with Recorder() as rec:
        _, metrics = step(TrainState.create(s["model"], tap), s["batch"], LOOP_SEED, "video")
    tnet = Net(s["t_weights"])
    bank = ref.prompt_bank(tnet, *s["prompts"]["video"], 6, s["cfg"]["model_config"])
    labels = ref.teacher_labels(tnet, s["batch"]["crop_visual_inputs"], bank, s["cfg"], TEMP)
    params = {n: w.clone().requires_grad_(True) for n, w in s["weights"].items()}
    res = ref.pretrain_loss(Net(params), s["batch"], labels, s["cfg"],
                            step_generator(LOOP_SEED, 0, torch.device("cpu")))
    return dict(metrics=metrics, grads=tap.grads, rec=rec, res=res, labels=labels,
                want_grads=gradients(res["loss"], params))


def test_each_objective_matches_the_reference(stepped):
    got, res = stepped["metrics"], stepped["res"]
    for key in ("itc_loss", "itm_loss", "mlm_loss", "mpm_loss", "loss"):
        assert abs(float(got[key]) - float(res[key].detach())) <= 2e-5, key
    assert float(res["mlm_loss"].detach()) > 0 and float(res["mpm_loss"].detach()) > 0
    (picks,) = stepped["rec"].picks
    for a, b in zip(picks, res["drawn"]):
        assert torch.equal(a, b)


def test_every_gradient_matches_the_reference(stepped):
    got, want = stepped["grads"], stepped["want_grads"]
    assert set(got) == set(want)
    scale = max(float(g.abs().max()) for g in want.values())
    for name, g in want.items():
        torch.testing.assert_close(got[name], g, rtol=0, atol=1e-4 * scale, msg=name)
    assert scale > 1e-2


def test_soft_labels_ignore_mask_and_kept_count_match_the_reference(stepped):
    (rec,) = stepped["rec"].labels
    want = stepped["labels"]
    torch.testing.assert_close(rec["soft"], want["soft"], rtol=0, atol=1e-4)
    assert torch.equal(rec["ignore"], want["ignore"])
    kept = int((~want["ignore"]).sum())
    assert kept > 0
    assert int(stepped["metrics"]["mpm_kept"]) == kept


def test_both_banks_match_the_reference(setup):
    tnet = Net(setup["t_weights"])
    for kind in ("video", "image"):
        want = ref.prompt_bank(tnet, *setup["prompts"][kind], 6, setup["cfg"]["model_config"])
        torch.testing.assert_close(setup["banks"][kind], want, rtol=0, atol=1e-5)
    assert not torch.allclose(setup["banks"]["video"], setup["banks"]["image"])


def test_two_processes_match_one_process_on_the_global_batch(tmp_path):
    """The toy pretraining step (dropout 0) over 2 gloo processes of 2 rows
    against one process on the 4 rows: every metric within 1e-5,
    ``mpm_kept`` (summed over the group) exactly, and the summed gradients
    within 1e-4 (``tests/test_torch_dp_step.py``'s tolerances; the gathers
    change fp32's summation order)."""
    from alpro_tpu_torch.train import step as port_step
    from alpro_tpu_torch.train.state import TrainState

    rng = np.random.RandomState(5)
    B, L = 4, 8
    mask = (np.arange(L)[None, :] < np.array([8, 5, 7, 6])[:, None]).astype(np.int32)
    ids = rng.randint(5, 100, (B, L)).astype(np.int32)
    labels = np.full((B, L), -100, np.int32)
    labels[0, 2], labels[1, 3], labels[2, 1], labels[3, 4] = 17, 40, 8, 9
    mlm_ids = np.where(labels != -100, 4, ids).astype(np.int32)
    pixels = rng.randint(0, 256, (B, 2, 32, 32, 3)).astype(np.uint8)
    crop = np.zeros_like(pixels)
    crop[:, :, :16, 16:] = pixels[:, :, :16, 16:]
    mpm_mask = np.ones((B, 2, 2), np.float32)
    mpm_mask[:, 0, 1] = 0
    batch = {"visual_inputs": pixels, "text_input_ids": ids, "text_input_mask": mask,
             "mlm_text_input_ids": mlm_ids, "mlm_labels": labels, "crop_visual_inputs": crop,
             "mpm_mask": mpm_mask}
    torch.manual_seed(3)
    model, teacher = W.build("pretrain"), W.build("prompter")
    teacher.eval().requires_grad_(False)
    bank = np.random.RandomState(3).randn(W.NUM_ENTITIES, 256).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=-1, keepdims=True)
    case = dict(kind="pretrain", make="pretrain", state=model.state_dict(),
                teacher=teacher.state_dict(), bank=bank, batch=batch, extras=("video",))
    torch.save({"pretrain": case}, tmp_path / "steps_in.pt")
    parts = W.spawn("steps", 2, str(tmp_path))

    tap = W.GradTap()
    banks = {"video": torch.from_numpy(bank), "image": torch.from_numpy(-bank)}
    step = port_step.make_pretrain_train_step(model, tap, teacher=teacher, banks=banks)
    _, metrics = step(TrainState.create(model, tap), W.rows_of(batch, 0, 1), 0, "video")
    _, ignore = port_step._teacher_pseudo_labels(
        teacher, {"crop_visual_inputs": torch.from_numpy(crop)}, banks["video"])
    assert int(metrics["mpm_kept"]) == B - int(ignore.sum())
    for part in parts:
        got = part["pretrain"]
        assert set(got["metrics"]) == set(metrics)
        assert got["metrics"]["mpm_kept"] == int(metrics["mpm_kept"])
        for k, v in metrics.items():
            np.testing.assert_allclose(got["metrics"][k], float(v), atol=1e-5, rtol=0,
                                       err_msg=k)
        for name, g in tap.grads.items():
            np.testing.assert_allclose(got["grads"][name], g.numpy(), atol=1e-4, rtol=0,
                                       err_msg=name)
