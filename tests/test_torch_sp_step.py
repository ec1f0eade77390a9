"""The model's sequence-parallel layout (``--mesh_shape DP SP``): the port's
retrieval train step on four gloo processes over a (2, 2) mesh, the video
tower built with ``sp_axis='sp'``, so that each process attends 16 of the
32 frames' queries in every divided block. The processes of sp rank 1 feed
no batch, as their CLI loaders read nothing: each step takes sp rank 0's
batch and extras.

(a) At the dims of JAX's ``tests/test_seq_parallel.py::
test_sp_train_step_e2e_t32`` (TimeSformer D 16, depth 2, 2 heads, T 32,
32²; BERT hidden 16, 2 layers, fusion 1), fp32, dropout and drop-path 0,
AdamW with grad_norm 5, global B = 2 (the hard-negative sampler has one
choice), random weights on the JAX init's tree: the loss and every
parameter after one step within 1e-5 of JAX's single-device step, the same
on all four processes, and AdamW's first moment (0.1 · the clipped
gradient) within 1e-5. The first moment is the check that sees the
gradient: Adam's first update is lr · g / (|g| + eps), which sees a
gradient scaled by SP only where |g| is near eps. The learning rate is 1e-4, not that test's 1e-3: at 1e-3 an
element with |g| near eps (1e-6) turns fp32 noise of ~4e-8 in g into 1e-5
of the parameter, and the unsplit step lands 1.04e-5 from JAX's there as
the split one does. The step is unclipped (the global gradient norm,
recorded before clipping, is below 5 and 10 · |JAX's first moment|), so
the first moment is 0.1 · g and a gradient off by a factor fails by far.
That test already holds JAX's (4, 2) mesh to the single-device step, so
JAX's 2-D mesh is not compiled here again.

(b) The same spawn, with dropout, attention dropout and drop-path 0.1 and
``attn_impl='pallas'``: the split step against the port's unsplit step
(``sp_axis`` None, the same mesh, generators and rows) within 1e-6: the
attention dropout draws the whole (B·N, H, T, T) mask and keeps its query
rows, so SP = 2 draws what SP = 1 draws; the first moments within 1e-6
too.

(c) Case (b)'s split step with the video blocks checkpointed and its
backward pass run on another thread, which starts without the step's
``use_mesh`` context, as the autograd engine's device thread on a GPU
does: the recompute must split as the forward did. One spawn of
``tests/torch_dist_worker.py`` runs every case.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_dist_worker as W
from alpro_tpu.models import BertConfig as JaxBertConfig
from alpro_tpu.models import TimeSformerConfig as JaxVisCfg
from alpro_tpu.models import build_retrieval_model as jax_build
from alpro_tpu.train import TrainState as JaxTrainState
from alpro_tpu.train import build_optimizer, get_lr_schedule
from alpro_tpu.train.step import make_retrieval_train_step
from alpro_tpu_torch.checkpoint.from_jax import alpro_state_dict
from alpro_tpu_torch.checkpoint.load import _to_port_keys, from_jax_params
from alpro_tpu_torch.models import alpro
from alpro_tpu_torch.models.bert import BertConfig
from alpro_tpu_torch.models.timesformer import TimeSformerConfig

JAX_ATOL, SPLIT_ATOL = 1e-5, 1e-6
B, T, L, LR = 2, 32, 6, 1e-4
VIS = dict(img_size=32, patch_size=16, num_frames=T, embed_dim=16, depth=2, num_heads=2,
           drop_path_rate=0.0)
BERT = dict(vocab_size=64, hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=32, fusion_layer=1, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
DROPS_VIS = dict(drop_rate=0.1, attn_drop_rate=0.1, drop_path_rate=0.1, attn_impl="pallas")
DROPS_BERT = dict(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1, attn_impl="pallas")


def _jax_params(model, batch):
    """Random weights on the init's tree (traced, not compiled): LayerNorm
    scales near 1, the temperature at 0.07, every other leaf ~ N(0, 0.05²)."""
    shapes = jax.eval_shape(model.init, {"params": jax.random.PRNGKey(0)},
                            batch["visual_inputs"][:1], batch["text_input_ids"][:1],
                            batch["text_input_mask"][:1])
    rng = np.random.RandomState(11)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['temp']"):
            return jnp.full(s.shape, 0.07, s.dtype)
        base = 1.0 if name.endswith("['scale']") else 0.0
        return jnp.asarray(base + 0.05 * rng.randn(*s.shape), s.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.RandomState(0)
    batch = {"visual_inputs": rng.randint(0, 256, (B, T, 32, 32, 3)).astype(np.uint8),
             "text_input_ids": rng.randint(1, 64, (B, L)).astype(np.int32),
             "text_input_mask": (np.arange(L)[None, :] < np.array([6, 4])[:, None])
             .astype(np.int32)}
    jm = jax_build(JaxBertConfig(**BERT), JaxVisCfg(**VIS))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = _jax_params(jm, jb)
    tx = build_optimizer(get_lr_schedule("constant", LR, 100), grad_norm=5.0)
    new, metrics = jax.jit(make_retrieval_train_step(jm, tx), compiler_options={
        "xla_backend_optimization_level": 0})(JaxTrainState.create(params, tx), jb,
                                              jax.random.PRNGKey(42))
    adam, = [s for s in jax.tree_util.tree_leaves(
        new.opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    want = ({k: float(v) for k, v in metrics.items()},
            *({k: v.numpy() for k, v in _to_port_keys(alpro_state_dict(
                jax.device_get(tree))).items()} for tree in (new.params, adam.mu)))
    port = alpro.build_retrieval_model(BertConfig(**BERT), TimeSformerConfig(**VIS), img_size=32,
                                       num_frm=T)
    from_jax_params(port, params)
    state = port.state_dict()
    cases = {
        "jax": dict(bert=BERT, vis=dict(VIS, sp_axis="sp"), state=state, lr=LR, batch=batch),
        "drop_split": dict(bert=dict(BERT, **DROPS_BERT), vis=dict(VIS, **DROPS_VIS, sp_axis="sp"),
                           state=state, lr=LR, batch=batch, seed=3),
        "drop_unsplit": dict(bert=dict(BERT, **DROPS_BERT), vis=dict(VIS, **DROPS_VIS),
                             state=state, lr=LR, batch=batch, seed=3),
        "ckpt_split": dict(bert=dict(BERT, **DROPS_BERT),
                           vis=dict(VIS, **DROPS_VIS, sp_axis="sp", gradient_checkpointing=True),
                           state=state, lr=LR, batch=batch, seed=3, backward_thread=True),
    }
    workdir = str(tmp_path_factory.mktemp("sp_step"))
    torch.save({"mesh": [2, 2], "cases": cases}, os.path.join(workdir, "sp_steps_in.pt"))
    return want, W.spawn("sp_steps", 4, workdir), state


def _close(got: dict, want: dict, atol: float, what: str) -> None:
    assert set(got) == set(want), what
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=atol, rtol=0, err_msg=f"{what}: {k}")


def test_sp_step_matches_the_jax_single_device_step(runs):
    """(a) Every process: the loss within 1e-5, every parameter after the
    AdamW step within 1e-5 of JAX's; the four processes' parameters equal;
    each process ran the split attention in both blocks."""
    (jmetrics, jparams, jmu), got, start = runs
    for rank, out in enumerate(got):
        case = out["jax"]
        assert case["split_calls"] == VIS["depth"], rank
        np.testing.assert_allclose(case["metrics"]["loss"], jmetrics["loss"], atol=JAX_ATOL,
                                   rtol=0)
        # unclipped (|g| < grad_norm 5), so AdamW's first moment is 0.1 · g
        # itself and a gradient off by a factor fails its check
        want_norm = 10 * np.sqrt(sum(float(np.sum(jmu[k].astype(np.float64) ** 2))
                                     for k in case["mu"]))
        assert case["grad_norm"] < 5.0, (rank, case["grad_norm"])
        np.testing.assert_allclose(case["grad_norm"], want_norm, rtol=1e-5)
        _close(case["mu"], {k: jmu[k] for k in case["mu"]}, JAX_ATOL, f"rank {rank} mu")
        _close(case["params"], {k: jparams[k] for k in case["params"]}, JAX_ATOL, f"rank {rank}")
        for k, v in case["params"].items():
            np.testing.assert_array_equal(v, got[0]["jax"]["params"][k], err_msg=k)
    moved = max(float(np.abs(v - start[k].numpy()).max())
                for k, v in got[0]["jax"]["params"].items())
    assert moved > 5e-5  # the step moved the parameters
    assert max(float(np.abs(m).max()) for m in got[0]["jax"]["mu"].values()) > 1e-3


def test_sp_step_takes_the_batch_and_extras_of_sp_rank_0(runs):
    """The processes of sp rank 1 fed no batch (their loaders read nothing)
    and other extras: each step saw sp rank 0's rows and extras."""
    _, got, _ = runs
    for rank, out in enumerate(got):
        lead = rank - rank % 2
        assert out["extras_seen"] == [(f"from rank {lead}", [[float(lead)] * 2])], rank
    assert got[1]["jax"]["metrics"] == got[0]["jax"]["metrics"]


def test_sp_step_with_dropout_matches_the_unsplit_step(runs):
    """(b) Dropout, attention dropout and drop-path on, ``attn_impl
    'pallas'``: SP = 2 within 1e-6 of the unsplit step, loss and every
    parameter, on every process."""
    _, got, _ = runs
    for rank, out in enumerate(got):
        split, whole = out["drop_split"], out["drop_unsplit"]
        assert split["split_calls"] == VIS["depth"] and whole["split_calls"] == 0
        _close(split["metrics"], whole["metrics"], SPLIT_ATOL, f"rank {rank} metrics")
        _close(split["params"], whole["params"], SPLIT_ATOL, f"rank {rank}")
        _close(split["mu"], whole["mu"], SPLIT_ATOL, f"rank {rank} mu")
    # dropout drew: the metrics differ from the dropout-free case's
    assert abs(got[0]["drop_split"]["metrics"]["loss"] - got[0]["jax"]["metrics"]["loss"]) > 1e-4


def test_sp_step_checkpointed_with_its_backward_on_another_thread(runs):
    """(c) The dropout case with the video blocks checkpointed and the
    backward pass on a thread that does not see the step's ``use_mesh``
    context (the autograd engine's device thread on a GPU): the recompute
    splits as the forward did, and the step equals the unsplit one within
    1e-6."""
    _, got, _ = runs
    for rank, out in enumerate(got):
        split, whole = out["ckpt_split"], out["drop_unsplit"]
        # the forward and the recompute each split both blocks
        assert split["split_calls"] == 2 * VIS["depth"], (rank, split["split_calls"])
        _close(split["metrics"], whole["metrics"], SPLIT_ATOL, f"rank {rank} metrics")
        _close(split["params"], whole["params"], SPLIT_ATOL, f"rank {rank}")
        _close(split["mu"], whole["mu"], SPLIT_ATOL, f"rank {rank} mu")

