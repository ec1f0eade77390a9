"""Port pretraining, pretrain-eval and prompter steps vs alpro_tpu's.

The toy ALPRO of ``tests/test_torch_train_step.py`` (BERT hidden 32, 2
heads, 4 layers, fusion_layer 2; TimeSformer D 32, depth 2, 32², T 2) with
both pretraining heads over 5 entities, the JAX init perturbed on every
leaf and loaded into the port; a frozen prompter teacher likewise; one
(5, 256) prompt bank; dropout and drop-path 0; each side's optimizer
replaced by one that keeps the step's gradient and moves nothing. B = 2: the
hard-negative sampler has one choice. The JAX kernels run in Pallas
interpret mode. fp32: every metric within atol 1e-5; every parameter's
gradient (JAX's mapped to the port's names through
``checkpoint/from_jax.py``) within 5e-5 of its own largest entry and within
1e-5 of the whole gradient's largest entry. The fp32 summation noise of a
step (oneDNN's and XLA's kernels, whose order varies with the run) reached
7.4e-6 of a tensor's own largest entry in one process and 1.4e-5 under
pytest-xdist with 6 workers. The BERT key biases (``ZERO_GRAD``) are held
to the whole gradient's scale only: their true gradient is 0 (softmax is
invariant to a shift shared by every key), so both sides hold rounding
noise of ~1e-10 of the whole gradient.
The teacher gets no gradient and its weights do not move. The step under
``attn_impl`` 'pallas' and with objectives off is in
``tests/test_torch_pretrain_steps_more.py``.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from alpro_tpu.models import BertConfig as JaxBertConfig
from alpro_tpu.models import TimeSformerConfig as JaxVisCfg
from alpro_tpu.models.alpro import build_pretrain_model as jax_build_pretrain
from alpro_tpu.models.alpro import build_prompter_model as jax_build_prompter
from alpro_tpu.train import step as jax_step
from alpro_tpu.train.state import TrainState as JaxTrainState
from alpro_tpu_torch.checkpoint.from_jax import alpro_state_dict
from alpro_tpu_torch.checkpoint.load import _to_port_keys, from_jax_params
from alpro_tpu_torch.models.alpro import build_pretrain_model, build_prompter_model
from alpro_tpu_torch.models.bert import BertConfig
from alpro_tpu_torch.models.timesformer import TimeSformerConfig
from alpro_tpu_torch.train import step as port_step
from alpro_tpu_torch.train.state import TrainState
from test_torch_train_step import BERT, NO_DROP_BERT, NO_DROP_VIS, VIS, _randomized

B, L, E = 2, 8, 5
METRIC_ATOL, GRAD_OWN_RTOL, GRAD_WHOLE_RTOL = 1e-5, 5e-5, 1e-5
ZERO_GRAD = re.compile(r"attention\.self\.key\.bias$")


def _pair(jax_build, port_build, attn_impl, seed, **kw):
    jm = jax_build(JaxBertConfig(**BERT, **NO_DROP_BERT, attn_impl=attn_impl),
                   JaxVisCfg(**VIS, **NO_DROP_VIS, attn_impl=attn_impl), img_size=32, num_frm=2,
                   **kw)
    params = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 2, 32, 32, 3)),
                     jnp.zeros((1, L), jnp.int32), jnp.ones((1, L), jnp.int32))
    params = _randomized(params, seed)
    port = port_build(BertConfig(**BERT, **NO_DROP_BERT, attn_impl=attn_impl),
                      TimeSformerConfig(**VIS, **NO_DROP_VIS, attn_impl=attn_impl), img_size=32,
                      num_frm=2, **kw)
    from_jax_params(port, params)
    return jm, params, port


def _setup(attn_impl="xla"):
    student = _pair(jax_build_pretrain, build_pretrain_model, attn_impl, 1, num_entities=E)
    teacher = _pair(jax_build_prompter, build_prompter_model, attn_impl, 2)
    teacher[2].eval().requires_grad_(False)
    bank = np.random.RandomState(3).randn(E, 256).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=-1, keepdims=True)
    return student, teacher, bank


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    mask = np.ones((B, L), np.int32)
    mask[1, 5:] = 0
    ids = rng.randint(5, 100, (B, L)).astype(np.int32)
    labels = np.full((B, L), -100, np.int32)
    labels[0, 2], labels[1, 3], labels[1, 1] = 17, 40, 8
    mlm_ids = ids.copy()
    mlm_ids[labels != -100] = 4
    pixels = rng.randint(0, 256, (B, 2, 32, 32, 3)).astype(np.uint8)
    crop = np.zeros_like(pixels)
    crop[:, :, :16, 16:] = pixels[:, :, :16, 16:]
    mpm_mask = np.ones((B, 2, 2), np.float32)
    mpm_mask[:, 0, 1] = 0
    return {"visual_inputs": pixels, "text_input_ids": ids, "text_input_mask": mask,
            "mlm_text_input_ids": mlm_ids, "mlm_labels": labels,
            "crop_visual_inputs": crop, "mpm_mask": mpm_mask}


class GradTap:
    """The port's optimizer interface: keeps each step's gradients by
    parameter name and moves nothing."""

    def init(self, named_params):
        self.names = list(named_params)
        return None

    def update(self, state, params, grads):
        self.grads = {n: g.detach().clone().numpy() for n, g in zip(self.names, grads)}
        return True


def jax_grad_tap() -> optax.GradientTransformation:
    """An optax transformation whose state becomes the step's gradient and
    whose updates are zero."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads))


def _jax_step(make, *args, **kwargs):
    """JAX's step built on ``jax_grad_tap`` and run once → (metrics,
    gradients by the port's names)."""
    tx = jax_grad_tap()
    model, params, batch = args[:3]
    step = jax.jit(make(model, tx, **kwargs))
    new, metrics = step(JaxTrainState.create(params, tx),
                        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0),
                        *args[3:])
    g = jax.device_get(new.opt_state)
    return metrics, {k: v.numpy() for k, v in _to_port_keys(alpro_state_dict(g)).items()}


def _check(jmetrics, pmetrics, jgrads, pgrads):
    """JAX's metrics and gradients; the port's one metric more with MPM,
    ``mpm_kept`` (the step's rows kept, which JAX does not report), a whole
    number of rows."""
    pmetrics = dict(pmetrics)
    if "mpm_loss" in jmetrics:
        kept = pmetrics.pop("mpm_kept")
        assert not kept.is_floating_point() and 0 <= int(kept) <= B
    assert set(pmetrics) == set(jmetrics)
    for key, value in pmetrics.items():
        np.testing.assert_allclose(float(value), float(jmetrics[key]), atol=METRIC_ATOL, rtol=0,
                                   err_msg=key)
    assert set(pgrads) == set(jgrads)
    whole = GRAD_WHOLE_RTOL * max(float(np.abs(g).max()) for g in jgrads.values())
    for name, g in pgrads.items():
        own = GRAD_OWN_RTOL * float(np.abs(jgrads[name]).max())
        atol = whole if ZERO_GRAD.search(name) else min(own, whole)
        np.testing.assert_allclose(g, jgrads[name], atol=atol, rtol=0, err_msg=name)


def test_pretrain_step_matches_jax():
    check_pretrain_step("xla")


def check_pretrain_step(attn_impl):
    """All four objectives, with the teacher and the video bank, under
    ``attn_impl`` on both sides."""
    (jm, params, port), (jt, tparams, tport), bank = _setup(attn_impl)
    batch = _batch()
    jmetrics, jgrads = _jax_step(jax_step.make_pretrain_train_step, jm, params, batch, tparams,
                                 jnp.asarray(bank), teacher=jt)
    teacher_before = {n: p.detach().clone() for n, p in tport.named_parameters()}
    tap = GradTap()
    state = TrainState.create(port, tap)
    step = port_step.make_pretrain_train_step(
        port, tap, teacher=tport, banks={"video": torch.from_numpy(bank),
                                         "image": torch.from_numpy(-bank)})
    state, pmetrics = step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, 0, "video")
    assert state.step == 1 and not port.training and not tport.training
    assert sorted(pmetrics) == ["itc_loss", "itm_loss", "loss", "mlm_loss", "mpm_kept",
                                "mpm_loss"]
    _, ignore = port_step._teacher_pseudo_labels(
        tport, {"crop_visual_inputs": torch.from_numpy(batch["crop_visual_inputs"])},
        torch.from_numpy(bank))
    assert int(pmetrics["mpm_kept"]) == B - int(ignore.sum())
    _check(jmetrics, pmetrics, jgrads, tap.grads)
    for n, p in tport.named_parameters():  # the teacher: no gradient, not moved
        assert p.grad is None and not p.requires_grad and torch.equal(p, teacher_before[n]), n


def test_pretrain_eval_fn_matches_jax():
    (jm, params, port), (jt, tparams, tport), bank = _setup()
    batch = _batch(2)
    want = jax.jit(jax_step.make_pretrain_eval_fn(jm, use_mpm=True, teacher=jt))(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0), tparams,
        jnp.asarray(bank))
    port.train()
    got = port_step.make_pretrain_eval_fn(port, use_mpm=True, teacher=tport)(
        {k: torch.from_numpy(v) for k, v in batch.items()}, torch.from_numpy(bank))
    assert port.training  # put back in its mode
    assert sorted(got) == sorted(want) == [
        "val_itc_loss", "val_itm_loss", "val_mlm_acc", "val_mlm_loss", "val_mpm_loss",
        "val_t2v_acc", "val_v2t_acc"]
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), atol=METRIC_ATOL, rtol=0, err_msg=k)


def test_prompter_step_matches_jax():
    jm, params, port = _pair(jax_build_prompter, build_prompter_model, "xla", 4)
    batch = {k: v for k, v in _batch(3).items() if not k.startswith(("mlm", "crop", "mpm"))}
    jmetrics, jgrads = _jax_step(jax_step.make_prompter_train_step, jm, params, batch)
    tap = GradTap()
    _, pmetrics = port_step.make_prompter_train_step(port, tap)(
        TrainState.create(port, tap), {k: torch.from_numpy(v) for k, v in batch.items()})
    assert sorted(pmetrics) == ["i2t_acc", "loss", "t2i_acc"]
    _check(jmetrics, pmetrics, jgrads, tap.grads)
