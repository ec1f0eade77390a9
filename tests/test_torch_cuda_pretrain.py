"""The pretraining step's device-side pieces, on the card.

Every test carries the ``cuda`` marker and skips without a CUDA device; the
file imports only torch and the port (no jax), so it runs on the machine
with the GPU: ``python -m pytest tests/test_torch_cuda_pretrain.py -m cuda``.
At base width (hidden 768, 12 heads) and shallow depth (TimeSformer depth
2, 224², T 4; BERT 4 layers, fusion at 2), bf16 compute, fp32 parameters,
dropout and drop-path 0, under ``attn_impl='pallas'``: a pretrain step
launches the masked attention (B13) for the student's spatial, text, VTM
fusion, MLM text and MLM fusion calls and the teacher's eval-mode video
tower its serving kernels (B13, K2, K3), no K1, no K4/K5; the teacher gets
no gradient, holds no optimizer state and does not move; the prompt bank
built through the teacher's text half with K4/K5 agrees with the plain
path's; with a bank whose labels decide every row (none ignored), the MPM
loss and the MPM head's gradient of the kernel path agree with the plain
path's.
"""

import dataclasses

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

DEPTH, LAYERS, FUSION, B, T, L, E = 2, 4, 2, 4, 4, 30, 10
BERT = dict(vocab_size=1000, num_hidden_layers=LAYERS, fusion_layer=FUSION,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0, attn_impl="pallas")
VIS = dict(img_size=224, patch_size=16, num_frames=T, depth=DEPTH, drop_path_rate=0.0,
           attn_impl="pallas")
# kernels vs plain, each about twice its reading on an H100 80GB HBM3 at
# 700 W (4.8e-4, 3.7e-4, 1.4e-2): the bank's entries (means of unit 256-d
# features); with no MPM row ignored, the MPM loss and the MPM head's
# gradient (the difference's L2 norm over the plain gradient's, per tensor:
# in bf16 a hidden unit near 0 can fall on the other side of the ReLU, so
# the largest entry of the difference can be a whole entry)
BANK_TOL, MPM_LOSS_TOL, MPM_GRAD_TOL = 1e-3, 8e-4, 3e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _model(build, cuda, seed, **kw):
    from alpro_tpu_torch.models.alpro import init_random_
    from alpro_tpu_torch.models.bert import BertConfig
    from alpro_tpu_torch.models.timesformer import TimeSformerConfig

    model = build(BertConfig(**BERT), TimeSformerConfig(**VIS), img_size=224, num_frm=T,
                  dtype=torch.bfloat16, **kw).to(cuda)
    return init_random_(model, torch.Generator(device=cuda).manual_seed(seed))


def _batch(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    pixels = torch.randint(0, 256, (B, T, 224, 224, 3), generator=g, device=cuda,
                           dtype=torch.uint8)
    ids = torch.randint(5, 1000, (B, L), generator=g, device=cuda, dtype=torch.int32)
    mask = torch.ones(B, L, dtype=torch.int32, device=cuda)
    mask[1, 12:] = 0
    labels = torch.full((B, L), -100, dtype=torch.int32, device=cuda)
    labels[:, 3] = ids[:, 3]
    crop = torch.zeros_like(pixels)
    crop[:, :, 64:160, 32:128] = pixels[:, :, 64:160, 32:128]
    mpm_mask = torch.ones(B, 14, 14, device=cuda)
    mpm_mask[:, 4:10, 2:8] = 0
    return {"visual_inputs": pixels, "text_input_ids": ids, "text_input_mask": mask,
            "mlm_text_input_ids": torch.where(labels != -100, 4, ids), "mlm_labels": labels,
            "crop_visual_inputs": crop, "mpm_mask": mpm_mask}


def _plain(model) -> None:
    """Both towers on the plain path (no kernel)."""
    vis, bert = model.visual_encoder.model, model.text_encoder.bert
    vis.cfg = dataclasses.replace(vis.cfg, attn_impl="plain", temporal_attn_impl="plain",
                                  mlp_impl="plain")
    bert.cfg = dataclasses.replace(bert.cfg, attn_impl="plain", block_impl="plain")


class _GradTap:
    """An optimizer that keeps the step's gradients by name and moves
    nothing."""

    def init(self, named_params):
        self.names = list(named_params)

    def update(self, state, params, grads):
        self.grads = {n: g.detach().float().clone() for n, g in zip(self.names, grads)}


def _counts():
    from alpro_tpu_torch.ops import bert_block, ln_mlp, masked_attn, qkv_attn

    return (masked_attn.bshd_launches, qkv_attn.spatial_launches, qkv_attn.temporal_launches,
            ln_mlp.launches, bert_block.attn_launches, bert_block.mlp_launches)


def test_pretrain_step_launches_and_frozen_teacher(cuda):
    from alpro_tpu_torch.models.alpro import build_pretrain_model, build_prompter_model
    from alpro_tpu_torch.train.optimizer import build_optimizer
    from alpro_tpu_torch.train.state import TrainState
    from alpro_tpu_torch.train.step import make_pretrain_train_step

    student = _model(build_pretrain_model, cuda, 0, num_entities=E)
    teacher = _model(build_prompter_model, cuda, 1).eval().requires_grad_(False)
    frozen = {k: v.clone() for k, v in teacher.state_dict().items()}
    bank = torch.nn.functional.normalize(torch.randn(E, 256, device=cuda), dim=-1)
    optimizer = build_optimizer(lambda step: 1e-4)
    state = TrainState.create(student, optimizer)
    step = make_pretrain_train_step(student, optimizer, teacher=teacher,
                                    banks={"video": bank, "image": bank})
    before = _counts()
    state, metrics = step(state, _batch(cuda), 0, "video")
    torch.cuda.synchronize()
    got = [a - b for a, b in zip(_counts(), before)]
    student_b13 = DEPTH + FUSION + (LAYERS - FUSION) + FUSION + (LAYERS - FUSION)
    # B13: the student's calls + the teacher's spatial; K1 none; K2 and K3 the
    # teacher's eval tower; K4/K5 none (no eval BERT call in a step)
    assert got == [student_b13 + DEPTH, 0, DEPTH, 2 * DEPTH, 0, 0], got
    assert all(torch.isfinite(v) for v in metrics.values()) and state.step == 1
    assert len(state.opt_state.mu) == len(list(student.parameters()))
    owned = {id(p) for p in student.parameters()}
    assert not any(id(p) in owned for p in teacher.parameters())
    for k, v in teacher.state_dict().items():
        assert torch.equal(v, frozen[k]), k
    assert all(p.grad is None and not p.requires_grad for p in teacher.parameters())


def test_prompt_bank_kernels_match_plain(cuda):
    from alpro_tpu_torch.models.alpro import build_prompter_model
    from alpro_tpu_torch.objectives.pem import build_prompt_bank

    teacher = _model(build_prompter_model, cuda, 2).eval().requires_grad_(False)
    g = torch.Generator(device=cuda).manual_seed(3)
    ids = torch.randint(5, 1000, (12 * E, 12), generator=g, device=cuda, dtype=torch.int32)
    mask = torch.ones_like(ids)
    mask[::3, 9:] = 0
    bert = teacher.text_encoder.bert

    def bank():
        with torch.no_grad():
            return build_prompt_bank(lambda i, m: teacher.text_feat(teacher.embed_text(i, m)),
                                     ids, mask, E, chunk_size=32)

    before = _counts()
    kern = bank()
    torch.cuda.synchronize()
    got = [a - b for a, b in zip(_counts(), before)]
    chunks = -(-12 * E // 32)
    assert got[4:] == [chunks * FUSION] * 2, got
    bert.cfg = dataclasses.replace(bert.cfg, block_impl="plain")
    before = _counts()
    plain = bank()
    assert [a - b for a, b in zip(_counts(), before)][4:] == [0, 0]
    gap = float((kern - plain).abs().max())
    print(f"bank kernels vs plain max |diff| {gap:.3e}")
    assert kern.shape == (E, 256) and gap < BANK_TOL, gap
    assert np.isfinite(kern.cpu().numpy()).all()


def test_pretrain_step_mpm_with_kept_rows(cuda):
    """Entity 0 of the bank is the direction of the teacher's mean crop
    feature, so every row's soft label peaks on it far above the 0.2
    threshold: no row is ignored, the MPM loss is positive and the MPM head
    gets a gradient. One step on the kernel path and one on the plain path
    from the same weights (the optimizer moves nothing) agree."""
    from alpro_tpu_torch.models.alpro import build_pretrain_model, build_prompter_model
    from alpro_tpu_torch.objectives.pem import pseudo_labels_from_feats
    from alpro_tpu_torch.train.state import TrainState
    from alpro_tpu_torch.train.step import make_pretrain_train_step

    student = _model(build_pretrain_model, cuda, 0, num_entities=E)
    teacher = _model(build_prompter_model, cuda, 1).eval().requires_grad_(False)
    batch = _batch(cuda)
    with torch.no_grad():
        feat = teacher.video_feat(teacher.embed_video(batch["crop_visual_inputs"]))
    g = torch.Generator(device=cuda).manual_seed(4)
    bank = torch.nn.functional.normalize(torch.randn(E, 256, generator=g, device=cuda), dim=-1)
    bank[0] = torch.nn.functional.normalize(feat.float().mean(dim=0), dim=0)
    soft, ignore = pseudo_labels_from_feats(feat, bank, teacher.temperature())
    assert not ignore.any() and bool((soft.argmax(dim=1) == 0).all()), soft.max(dim=1)
    got = {}
    for path in ("kernels", "plain"):
        if path == "plain":
            _plain(student)
            _plain(teacher)
        tap = _GradTap()
        step = make_pretrain_train_step(student, tap, teacher=teacher,
                                        banks={"video": bank, "image": bank})
        before = _counts()
        _, metrics = step(TrainState.create(student, tap), batch, 0, "video")
        torch.cuda.synchronize()
        launched = [a - b for a, b in zip(_counts(), before)]
        assert (path == "kernels") == any(launched), launched
        heads = {n: v for n, v in tap.grads.items() if n.startswith("mpm_head.")}
        assert sorted(heads) == ["mpm_head.0.bias", "mpm_head.0.weight", "mpm_head.2.bias",
                                 "mpm_head.2.weight"]
        got[path] = (float(metrics["mpm_loss"]), heads)
    (kloss, kgrads), (ploss, pgrads) = got["kernels"], got["plain"]
    grad_gap = max(float((kgrads[n] - v).norm() / v.norm()) for n, v in pgrads.items())
    print(f"MPM loss kernels {kloss:.6f} plain {ploss:.6f} |diff| {abs(kloss - ploss):.3e}; "
          f"MPM head gradient relative L2 {grad_gap:.3e}")
    assert np.isfinite(kloss) and ploss > 0 and abs(kloss - ploss) < MPM_LOSS_TOL
    assert all(float(v.abs().max()) > 0 for v in pgrads.values())
    assert grad_gap < MPM_GRAD_TOL
