"""The port's data-parallel train steps (``train/step.py::shard_step``) on two
gloo processes against the JAX ``shard_step`` on a 2-device mesh.

The toy ALPRO of ``tests/test_torch_train_step.py`` (BERT hidden 32, 2
heads, 4 layers, fusion_layer 2; TimeSformer D 32, depth 2, 32², T 2), fp32,
dropout and drop-path 0, random weights on the JAX init's tree loaded into
the port. Each side's optimizer keeps the step's gradient and moves
nothing. Global B = 2, one row a process: the hard-negative sampler has one
choice (the other example), so both sides fuse the same negatives. The
pretraining step (VTC + VTM + MLM + MPM with the frozen teacher: one masked
token in row 0 and two in row 1, so the processes' MLM counts differ) and
the prompter step on the teacher: every metric within atol 1e-5 and every
gradient within 1e-4 of JAX's, the same on both processes (the retrieval
and QA steps: ``tests/test_torch_dp_step_tasks.py``; the JAX compiles are
most of each file's time). Then the port against itself: the retrieval step on 2
processes × B 2 against one process × B 4, the hard negatives equal and the
metrics within 1e-5. One spawn of the workers (``tests/torch_dist_worker.py``)
runs every case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_dist_worker as W
from alpro_tpu.core.mesh import make_mesh
from alpro_tpu.models import BertConfig as JaxBertConfig
from alpro_tpu.models import TimeSformerConfig as JaxVisCfg
from alpro_tpu.models import alpro as jax_alpro
from alpro_tpu.train import step as jax_step
from alpro_tpu.train.state import TrainState as JaxTrainState
from alpro_tpu_torch.checkpoint.from_jax import alpro_state_dict
from alpro_tpu_torch.checkpoint.load import _to_port_keys, from_jax_params
from alpro_tpu_torch.train import step as port_step
from alpro_tpu_torch.train.state import TrainState
from test_torch_pretrain_steps import _batch as pretrain_batch
from test_torch_pretrain_steps import jax_grad_tap
from test_torch_train_step import _batch

METRIC_ATOL, GRAD_ATOL = 1e-5, 1e-4
L = 8


def _pair(kind, seed, **kw):
    jm = getattr(jax_alpro, f"build_{kind}_model")(
        JaxBertConfig(**W.BERT, **W.NO_DROP_BERT, attn_impl="xla"),
        JaxVisCfg(**W.VIS, **W.NO_DROP_VIS, attn_impl="xla"), img_size=32, num_frm=2, **kw)
    # random weights on the init's tree (traced, not compiled): LayerNorm
    # scales near 1, the temperature at 0.07, every other leaf ~ N(0, 0.05²)
    shapes = jax.eval_shape(jm.init, {"params": jax.random.PRNGKey(0)},
                            jnp.zeros((1, 2, 32, 32, 3)), jnp.zeros((1, L), jnp.int32),
                            jnp.ones((1, L), jnp.int32))
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['temp']"):
            return jnp.full(s.shape, 0.07, s.dtype)
        base = 1.0 if name.endswith("['scale']") else 0.0
        return jnp.asarray(base + 0.05 * rng.randn(*s.shape), s.dtype)

    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    port = W.build(kind)
    from_jax_params(port, params)
    return jm, params, port


def _jax_global_step(make, model, params, batch, *extras, **kw):
    """JAX's step over a 2-device dp mesh, its state and extras replicated
    and the batch split over dp → (metrics, gradients by the port's names)."""
    mesh = make_mesh(devices=jax.devices()[:2])
    tx = jax_grad_tap()
    repl, data = NamedSharding(mesh, P()), NamedSharding(mesh, P("dp"))
    step = jax.jit(make(model, tx, **kw), in_shardings=(repl, data, repl) + (repl,) * len(extras),
                   compiler_options={"xla_backend_optimization_level": 0})
    new, metrics = step(JaxTrainState.create(params, tx),
                        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0),
                        *extras)
    grads = jax.device_get(new.opt_state)
    return ({k: float(v) for k, v in metrics.items()},
            {k: v.numpy() for k, v in _to_port_keys(alpro_state_dict(grads)).items()})


def _spawned(workdir, cases, want):
    torch.save(cases, f"{workdir}/steps_in.pt")
    return want, cases, W.spawn("steps", 2, workdir)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's global steps, and one spawn of the port's steps on 2 processes."""
    cases, want = {}, {}
    # the pretraining model and its frozen teacher
    jm, params, port = _pair("pretrain", 1, num_entities=W.NUM_ENTITIES)
    jt, tparams, tport = _pair("prompter", 2)
    # the port against itself (B 4 over 2 processes) from the same weights
    rng = np.random.RandomState(7)
    big = {"visual_inputs": rng.randint(0, 256, (4, 2, 32, 32, 3)).astype(np.uint8),
           "text_input_ids": rng.randint(1, 100, (4, L)).astype(np.int32),
           "text_input_mask": (np.arange(L)[None, :] < np.array([8, 5, 7, 6])[:, None])
           .astype(np.int32)}
    cases["self"] = dict(kind="pretrain", make="retrieval", state=port.state_dict(), batch=big)
    bank = np.random.RandomState(3).randn(W.NUM_ENTITIES, 256).astype(np.float32)
    bank /= np.linalg.norm(bank, axis=-1, keepdims=True)
    batch = pretrain_batch()
    assert [(batch["mlm_labels"][r] != -100).sum() for r in range(2)] == [1, 2]
    cases["pretrain"] = dict(kind="pretrain", make="pretrain", state=port.state_dict(),
                             teacher=tport.state_dict(), bank=bank, batch=batch,
                             extras=("video",))
    want["pretrain"] = _jax_global_step(jax_step.make_pretrain_train_step, jm, params, batch,
                                        tparams, jnp.asarray(bank), teacher=jt)
    # the prompter step on the teacher's weights
    batch = {k: v for k, v in pretrain_batch(3).items()
             if not k.startswith(("mlm", "crop", "mpm"))}
    cases["prompter"] = dict(kind="prompter", make="prompter", state=tport.state_dict(),
                             batch=batch)
    want["prompter"] = _jax_global_step(jax_step.make_prompter_train_step, jt, tparams, batch)
    return _spawned(str(tmp_path_factory.mktemp("dp_step")), cases, want)


def _check(want, got):
    jmetrics, jgrads = want
    metrics = dict(got["metrics"])
    if "mpm_loss" in jmetrics:  # the port's rows kept, summed over dp; JAX reports none
        kept = metrics.pop("mpm_kept")
        assert kept == int(kept) and 0 <= kept <= 2
    assert set(metrics) == set(jmetrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(v, jmetrics[k], atol=METRIC_ATOL, rtol=0, err_msg=k)
    assert set(got["grads"]) == set(jgrads)
    for name, g in got["grads"].items():
        np.testing.assert_allclose(g, jgrads[name], atol=GRAD_ATOL, rtol=0, err_msg=name)
    assert max(float(np.abs(g).max()) for g in got["grads"].values()) > 1e-2


def _check_both(runs, case):
    want, _, got = runs
    for rank in range(2):
        _check(want[case], got[rank][case])
    for name, g in got[0][case]["grads"].items():  # the summed gradient, on both
        np.testing.assert_array_equal(got[1][case]["grads"][name], g, err_msg=name)


@pytest.mark.parametrize("case", ["pretrain", "prompter"])
def test_two_processes_match_the_jax_global_step(runs, case):
    _check_both(runs, case)


PRETRAIN_SPANS = {"alpro.pretrain.vtc", "alpro.pretrain.vtm", "alpro.pretrain.mlm",
                  "alpro.pretrain.mpm", "alpro.teacher"}


def test_wrapped_step_spans_forward_backward_reduce_optimizer(runs):
    """With a process group the step's spans are, in order, forward (holding
    the model spans, and in a pretraining step each objective's and the
    teacher's), backward, reduce (the all-reduce) and optimizer, on every
    process and in every case, all under the micro-step's rid."""
    _, cases, got = runs
    for rank in range(2):
        for name in cases:
            spans = got[rank][name]["spans"]
            (step,) = [s for s in spans if s["name"] == "alpro.step"]
            assert (step["parent"], step["rid"]) == (None, 0)
            kids = sorted((s for s in spans if s["parent"] == step["id"]),
                          key=lambda s: s["start"])
            assert [k["name"] for k in kids] == ["alpro.step.forward", "alpro.step.backward",
                                                 "alpro.step.reduce", "alpro.step.optimizer"]
            assert all(a["end"] <= b["start"] for a, b in zip(kids, kids[1:]))
            forward, frontier = [], {kids[0]["id"]}
            while frontier:
                below = [s for s in spans if s["parent"] in frontier]
                forward += below
                frontier = {s["id"] for s in below}
            assert "alpro.video" in {s["name"] for s in forward}
            model_spans = {"alpro.video", "alpro.text", "alpro.fusion"}
            if cases[name]["make"] == "pretrain":
                assert {s["name"] for s in forward} == model_spans | PRETRAIN_SPANS
            else:
                assert {s["name"] for s in forward} <= model_spans
            assert len(spans) == 1 + len(kids) + len(forward)
            assert {s["rid"] for s in spans} == {0}


def test_two_processes_match_one_process_on_the_whole_batch(runs):
    """2 × B 2 against 1 × B 4: the same hard negatives (global indices),
    the metrics within 1e-5, the gradients within 1e-4."""
    _, cases, got = runs
    case = cases["self"]
    model = W.build(case["kind"])
    model.load_state_dict(case["state"])
    drawn = []
    sample = port_step.sample_hard_negatives

    def record(*args, **kw):
        drawn.append(sample(*args, **kw))
        return drawn[-1]

    tap = W.GradTap()
    port_step.sample_hard_negatives = record
    try:
        _, metrics = port_step.make_retrieval_train_step(model, tap)(
            TrainState.create(model, tap), {k: torch.from_numpy(v) for k, v in
                                           case["batch"].items()}, 0)
    finally:
        port_step.sample_hard_negatives = sample
    (neg_text, neg_video), = drawn
    ranks = [got[r]["self"] for r in range(2)]
    for i, want in enumerate((neg_text, neg_video)):
        split = np.concatenate([r["negatives"][0][i] for r in ranks])
        np.testing.assert_array_equal(split, want.numpy())
    for k, v in metrics.items():
        np.testing.assert_allclose(ranks[0]["metrics"][k], float(v), atol=METRIC_ATOL, rtol=0,
                                   err_msg=k)
    for name, g in tap.grads.items():
        np.testing.assert_allclose(ranks[0]["grads"][name], g.numpy(), atol=GRAD_ATOL, rtol=0,
                                   err_msg=name)
