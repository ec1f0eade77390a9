"""Port train steps (``alpro_tpu_torch.train.step``) vs alpro_tpu's.

The toy ALPRO (BERT hidden 32, 2 heads, 4 layers, fusion_layer 2;
TimeSformer D 32, depth 2, 32², T 2) with the same weights on both sides,
dropout and drop-path at 0, and both steps built with plain SGD at lr 1, so
that each parameter's change is its gradient. At B = 2 the hard-negative
sampler has one choice (the other example), so both sides fuse the same
negatives. The JAX kernels run in Pallas interpret mode. fp32: losses within
atol 1e-5; every parameter's gradient, mapped to the port's names through
``checkpoint/from_jax.py``, within atol 1e-4. Retrieval under ``attn_impl``
'xla' and 'pallas'; QA with 1 and 2 clips and with 2 options.

Then, port only: with dropout and drop-path on, the gradients are the same
with and without per-block gradient checkpointing (the recompute must draw
the masks the forward drew) and change with the seed; under both ported
``remat_policy`` values, ``nothing`` and ``dots_ln``, and ``attn_impl``
'xla' and 'pallas', exactly, ``dots_ln`` keeping the products and the
LayerNorm statistics it names.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from alpro_tpu.models import BertConfig as JaxBertConfig
from alpro_tpu.models import TimeSformerConfig as JaxVisCfg
from alpro_tpu.models import build_qa_model as jax_build_qa
from alpro_tpu.models import build_retrieval_model as jax_build_retrieval
from alpro_tpu.train import step as jax_step
from alpro_tpu.train.state import TrainState as JaxTrainState
from alpro_tpu_torch.checkpoint.from_jax import alpro_state_dict
from alpro_tpu_torch.checkpoint.load import _to_port_keys, from_jax_params
from alpro_tpu_torch.models.alpro import build_qa_model, build_retrieval_model
from alpro_tpu_torch.models.bert import BertConfig
from alpro_tpu_torch.models.timesformer import TimeSformerConfig
from alpro_tpu_torch.ops import masked_attn
from alpro_tpu_torch.train.state import TrainState
from alpro_tpu_torch.train.step import make_qa_train_step, make_retrieval_train_step

BERT = dict(vocab_size=100, hidden_size=32, num_hidden_layers=4, num_attention_heads=2,
            intermediate_size=64, fusion_layer=2)
VIS = dict(img_size=32, patch_size=16, num_frames=2, embed_dim=32, depth=2, num_heads=2)
NO_DROP_BERT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
NO_DROP_VIS = dict(drop_rate=0.0, drop_path_rate=0.0)
B, L = 2, 8


class SGD:
    """lr-1 SGD in the port's optimizer interface: p -= g."""

    def init(self, named_params):
        return None

    def update(self, state, params, grads):
        for p, g in zip(params, grads):
            p.sub_(g)
        return True


def _randomized(params, seed):
    """The JAX init with every leaf perturbed (LN scales and biases too)."""
    leaves, tree = jax.tree.flatten(params)
    rng = np.random.RandomState(seed)
    return jax.tree.unflatten(tree, [jnp.asarray(np.asarray(x) + np.asarray(
        0.05 * rng.randn(*np.shape(x)), np.float32)) for x in leaves])


def _models(attn_impl, num_labels=0, T=2, vis_impls=None, block_impl="auto"):
    """``vis_impls``: TimeSformer ``*_impl`` fields set on both sides (then
    ``attn_impl`` applies to BERT only)."""
    vis_impls = vis_impls or dict(attn_impl=attn_impl)
    jb = JaxBertConfig(**BERT, **NO_DROP_BERT, attn_impl=attn_impl, block_impl=block_impl)
    jv = JaxVisCfg(**VIS, **NO_DROP_VIS, **vis_impls)
    pb = BertConfig(**BERT, **NO_DROP_BERT, attn_impl=attn_impl, block_impl=block_impl)
    pv = TimeSformerConfig(**VIS, **NO_DROP_VIS, **vis_impls)
    if num_labels:
        jm = jax_build_qa(jb, jv, num_labels=num_labels, img_size=32, num_frm=T)
        port = build_qa_model(pb, pv, num_labels=num_labels, img_size=32, num_frm=T)
    else:
        jm = jax_build_retrieval(jb, jv, img_size=32, num_frm=T)
        port = build_retrieval_model(pb, pv, img_size=32, num_frm=T)
    params = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, T, 32, 32, 3)),
                     jnp.zeros((1, L), jnp.int32), jnp.ones((1, L), jnp.int32))
    params = _randomized(params, 1)
    from_jax_params(port, params)
    return jm, params, port


def _batch(frames, rows=B, seed=0, labels=None):
    rng = np.random.RandomState(seed)
    mask = np.ones((rows, L), np.int32)
    mask[1, 5:] = 0
    batch = {"visual_inputs": rng.randint(0, 256, (B, frames, 32, 32, 3)).astype(np.uint8),
             "text_input_ids": rng.randint(1, 100, (rows, L)).astype(np.int32),
             "text_input_mask": mask}
    if labels is not None:
        batch["labels"] = np.asarray(labels, np.int32)
    return batch


def _run_both(jm, params, port, make_jax, make_port, batch):
    """One step each; returns (jax metrics, port metrics, jax grads, port
    grads), the grads keyed by the port's parameter names."""
    tx = optax.sgd(1.0)
    jstate = JaxTrainState.create(params, tx)
    new, jmetrics = jax.jit(make_jax(jm, tx))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    jgrads = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), params, new.params)
    jgrads = {k: v.numpy() for k, v in _to_port_keys(alpro_state_dict(jgrads)).items()}

    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    sgd = SGD()
    state = TrainState.create(port, sgd)
    state, pmetrics = make_port(port, sgd)(state, {k: torch.from_numpy(v) for k, v in
                                                   batch.items()}, 0)
    assert state.step == 1 and not port.training
    pgrads = {n: (before[n] - p.detach()).numpy() for n, p in port.named_parameters()}
    return jmetrics, pmetrics, jgrads, pgrads


def _check(jmetrics, pmetrics, jgrads, pgrads):
    for key, value in pmetrics.items():
        np.testing.assert_allclose(float(value), float(jmetrics[key]), atol=1e-5, rtol=0,
                                   err_msg=key)
    assert set(pgrads) == set(jgrads)
    for name, g in pgrads.items():
        np.testing.assert_allclose(g, jgrads[name], atol=1e-4, rtol=0, err_msg=name)
    assert max(np.abs(g).max() for g in pgrads.values()) > 1e-2


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
def test_retrieval_step_matches_jax(attn_impl):
    jm, params, port = _models(attn_impl)
    n = masked_attn.bshd_launches
    jmetrics, pmetrics, jgrads, pgrads = _run_both(
        jm, params, port, lambda m, tx: jax_step.make_retrieval_train_step(m, tx),
        make_retrieval_train_step, _batch(2))
    assert set(pmetrics) == {"loss", "vtc_loss", "vtm_loss"}
    assert masked_attn.bshd_launches == n  # the CPU runs the twin
    _check(jmetrics, pmetrics, jgrads, pgrads)


def test_retrieval_step_with_explicit_kernel_impls_matches_jax():
    """In training, explicit ``fused_qkv`` (spatial) and ``fused_qkv_fold``
    (temporal) run K1/K2 with their backward (the temporal projections
    unfolded), explicit ``fused`` MLP tail and BERT block give the plain
    paths — on both sides (the JAX kernels in interpret mode)."""
    jm, params, port = _models("xla", vis_impls=dict(
        attn_impl="fused_qkv", temporal_attn_impl="fused_qkv_fold", mlp_impl="fused"),
        block_impl="fused")
    _check(*_run_both(jm, params, port, lambda m, tx: jax_step.make_retrieval_train_step(m, tx),
                      make_retrieval_train_step, _batch(2, seed=1)))
    x = torch.zeros(1, 2, 4, 32)
    cfg = port.visual_encoder.model.cfg
    assert [cfg.impl(f, x, True) for f in ("attn_impl", "temporal_attn_impl", "mlp_impl")] == [
        "fused_qkv", "fused_qkv", "plain"]
    assert [cfg.impl(f, x, False) for f in ("attn_impl", "temporal_attn_impl", "mlp_impl")] == [
        "fused_qkv", "fused_qkv_fold", "fused"]
    auto = TimeSformerConfig(**VIS)
    assert auto.impl("attn_impl", x, False) == "plain"  # a CPU tensor
    assert not port.text_encoder.bert.cfg.use_fused(x, training=True)
    assert port.text_encoder.bert.cfg.use_fused(x, training=False)


@pytest.mark.parametrize("attn_impl", ["fused_qkv_proj", "cls_sideband"])
def test_retrieval_step_with_serving_only_impls_matches_jax(attn_impl):
    """In training, JAX's serving-only forms map as JAX maps them:
    ``fused_qkv_proj`` on both axes is ``fused_qkv`` (K1/K2 with their
    backward), ``cls_sideband`` defers to ``auto`` (the plain path) — on
    both sides (the JAX kernels in interpret mode)."""
    t_impl = attn_impl if attn_impl == "fused_qkv_proj" else "auto"
    jm, params, port = _models("xla", vis_impls=dict(attn_impl=attn_impl,
                                                     temporal_attn_impl=t_impl))
    _check(*_run_both(jm, params, port, lambda m, tx: jax_step.make_retrieval_train_step(m, tx),
                      make_retrieval_train_step, _batch(2, seed=2)))


@pytest.mark.parametrize("n_clips,n_options", [(1, 1), (2, 1), (1, 2)])
def test_qa_step_matches_jax(n_clips, n_options):
    num_labels = 1 if n_options > 1 else 5
    jm, params, port = _models("xla", num_labels=num_labels)
    labels = [1, 0] if n_options > 1 else [3, 1]
    batch = _batch(2 * n_clips, rows=B * n_options, labels=labels)
    kw = dict(n_options=n_options, n_clips=n_clips, num_frm=2)
    jmetrics, pmetrics, jgrads, pgrads = _run_both(
        jm, params, port, lambda m, tx: jax_step.make_qa_train_step(m, tx, **kw),
        lambda m, opt: make_qa_train_step(m, opt, **kw), batch)
    _check(jmetrics, pmetrics, jgrads, pgrads)


def _port_grads(port, seed):
    sgd = SGD()
    model = copy.deepcopy(port)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = TrainState.create(model, sgd)
    make_retrieval_train_step(model, sgd)(state, {k: torch.from_numpy(v) for k, v in
                                                  _batch(2, seed=3).items()}, seed)
    return {n: before[n] - p.detach() for n, p in model.named_parameters()}


def test_checkpointing_keeps_the_dropout_masks():
    port = build_retrieval_model(BertConfig(**BERT), TimeSformerConfig(**VIS, drop_rate=0.1),
                                 img_size=32, num_frm=2)
    from_jax_params(port, _models("xla")[1])
    plain = _port_grads(port, seed=5)
    for cfg in (port.visual_encoder.model, port.text_encoder.bert):
        cfg.cfg = type(cfg.cfg)(**{**cfg.cfg.__dict__, "gradient_checkpointing": True})
    ckpt = _port_grads(port, seed=5)
    for name, g in plain.items():
        torch.testing.assert_close(ckpt[name], g, rtol=0, atol=1e-6, msg=name)
    other = _port_grads(port, seed=6)
    assert max(float((other[n] - g).abs().max()) for n, g in plain.items()) > 1e-3


def test_smoke_gradient_check_catches_a_dropped_key_gradient(monkeypatch):
    """``chip_smoke.py`` phase 6(b)'s pallas-vs-xla gradient check: with the
    masked attention's dk dropped, the whole gradient's relative L2 distance
    stays within its tolerance, and the per-parameter limits fail it."""
    import chip_smoke

    xla = _port_grads(_models("xla")[2], seed=0)
    gap = chip_smoke.grad_gaps(_port_grads(_models("pallas")[2], seed=0), xla)
    assert len(gap["qkv"]) == 2 + 3 * 4
    assert gap["whole"] < 1e-4 and gap["params"][0][1] < 1e-3, gap["params"][:3]

    grads = masked_attn.attention_grads
    monkeypatch.setattr(masked_attn, "attention_grads",
                        lambda *a: (lambda dq, dk, dv: (dq, torch.zeros_like(dk), dv))(*grads(*a)))
    gap = chip_smoke.grad_gaps(_port_grads(_models("pallas")[2], seed=0), xla)
    assert gap["whole"] < chip_smoke.FT_GRAD_TOL
    assert gap["qkv"][0][1] > chip_smoke.FT_QKV_GRAD_TOL
    assert gap["params"][0][1] > chip_smoke.FT_PARAM_GRAD_TOL


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
def test_remat_policies_keep_the_gradients(attn_impl, monkeypatch):
    """Dropout (0.1 on BERT's hidden states and attention probabilities,
    the video tower's tokens) and drop-path 0.1 on: one retrieval step's
    gradients under per-block checkpointing of both towers with
    ``remat_policy`` 'nothing' and 'dots_ln' equal those without
    checkpointing bit for bit, and ``dots_ln`` keeps ``aten.mm``/``addmm``
    outputs and the LayerNorms' ``aten.mean`` statistics in the forward,
    and nothing else."""
    import dataclasses

    from alpro_tpu_torch.models import remat
    from alpro_tpu_torch.models.alpro import init_random_

    port = build_retrieval_model(BertConfig(**BERT, attn_impl=attn_impl),
                                 TimeSformerConfig(**VIS, attn_impl=attn_impl, drop_rate=0.1,
                                                   drop_path_rate=0.1),
                                 img_size=32, num_frm=2)
    init_random_(port, torch.Generator().manual_seed(4))
    saved = []
    policy = remat._dots_ln

    def recording(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        if ctx.is_recompute is False and decision.name == "MUST_SAVE":
            saved.append(op)
        return decision

    monkeypatch.setattr(remat, "_dots_ln", recording)
    grads = {}
    for name in (None, "nothing", "dots_ln"):
        model = copy.deepcopy(port)
        if name is not None:
            for sub in (model.visual_encoder.model, model.text_encoder.bert):
                sub.cfg = dataclasses.replace(sub.cfg, gradient_checkpointing=True,
                                              remat_policy=name)
        grads[name] = _port_grads(model, seed=5)
    aten = torch.ops.aten
    assert {aten.addmm.default, aten.mean.dim} <= set(saved) <= {
        aten.mm.default, aten.addmm.default, aten.mean.dim}
    for name in ("nothing", "dots_ln"):
        for key, g in grads[None].items():
            assert torch.equal(grads[name][key], g), (name, key)
    assert max(float(g.abs().max()) for g in grads[None].values()) > 1e-3
