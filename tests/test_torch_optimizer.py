"""Port optimizer and schedules (``alpro_tpu_torch.train.optimizer``) vs
alpro_tpu's optax chain.

The schedules over 50 steps (relative 1e-6: the JAX ones run in fp32); five
AdamW updates on identical numpy parameters and gradients, with and without
gradient clipping, masked weight decay, accumulation over 2 calls and a bf16
first moment (and both moments), parameters within atol 1e-7 (they are ~0.05 in size, where one
fp32 ulp is ~4e-9); and the weight-decay mask on a model's ALPRO keys equal
to the JAX mask on its tree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from alpro_tpu.models import BertConfig as JaxBertConfig
from alpro_tpu.models import TimeSformerConfig as JaxVisCfg
from alpro_tpu.models import build_retrieval_model as jax_build
from alpro_tpu.train import optimizer as jopt
from alpro_tpu_torch.checkpoint.from_jax import alpro_state_dict
from alpro_tpu_torch.checkpoint.load import _to_port_keys
from alpro_tpu_torch.models.alpro import build_retrieval_model
from alpro_tpu_torch.models.bert import BertConfig
from alpro_tpu_torch.models.timesformer import TimeSformerConfig
from alpro_tpu_torch.train import optimizer as topt

SCHEDULES = [
    dict(decay="linear", learning_rate=1e-3, num_train_steps=40),
    dict(decay="invsqrt", learning_rate=1e-3, num_train_steps=40),
    dict(decay="constant", learning_rate=1e-3, num_train_steps=40),
    dict(decay="multi_step", learning_rate=1e-3, num_train_steps=40, decay_epochs=(2, 4),
         steps_per_epoch=7),
]


@pytest.mark.parametrize("kw", SCHEDULES, ids=lambda kw: kw["decay"])
def test_schedules_match_jax(kw):
    want, got = jopt.get_lr_schedule(**kw), topt.get_lr_schedule(**kw)
    for step in range(50):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=0)


def test_schedule_pieces_match_jax():
    for n in range(8):
        assert topt.multi_step_schedule(n, [2, 5]) == jopt.multi_step_schedule(n, [2, 5])
    for step in (0, 3, 10, 11, 30):
        np.testing.assert_allclose(topt.warmup_linear(step, 10, 30),
                                   float(jopt.warmup_linear(step, 10, 30)), rtol=1e-6)
        np.testing.assert_allclose(topt.noam_schedule(step, 10),
                                   float(jopt.noam_schedule(step, 10)), rtol=1e-6)
    with pytest.raises(ValueError):
        topt.get_lr_schedule("cosine", 1e-3, 10)


# leaf → (JAX tree path, port name): the naming of each side's _wd_mask
LEAVES = {
    ("enc", "dense", "kernel"): ("enc.dense.weight", (6, 4)),
    ("enc", "dense", "bias"): ("enc.dense.bias", (4,)),
    ("enc", "ln", "scale"): ("enc.ln.weight", (4,)),
    ("enc", "emb", "embedding"): ("enc.emb.weight", (5, 4)),
    ("enc", "pos_embed"): ("enc.pos_embed", (1, 3, 4)),
    ("temp",): ("temp", ()),
}


def _tree(values):
    tree = {}
    for path, v in zip(LEAVES, values):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = v
    return tree


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


OPTS = [
    dict(),
    dict(grad_norm=1.0),
    dict(weight_decay=0.05, apply_weight_decay=True),
    dict(accum_steps=2, grad_norm=5.0),
    dict(mu_dtype="bfloat16"),
    dict(mu_dtype="bfloat16", nu_dtype="bfloat16"),
]


@pytest.mark.parametrize("kw", OPTS, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items())
                         or "plain")
def test_adamw_matches_optax(kw):
    rng = np.random.RandomState(0)
    init = [np.asarray(0.05 * rng.randn(*shape), np.float32) for _, shape in LEAVES.values()]
    calls = 5 * kw.get("accum_steps", 1)
    grads = [[np.asarray(rng.randn(*shape), np.float32) for _, shape in LEAVES.values()]
             for _ in range(calls)]
    sched = dict(decay="linear", learning_rate=1e-3, num_train_steps=20)

    tx = jopt.build_optimizer(jopt.get_lr_schedule(**sched), **kw)
    jparams = _tree([jnp.asarray(x) for x in init])
    jstate = tx.init(jparams)

    @jax.jit  # as the JAX train step runs it
    def apply(g, s, p):
        updates, s = tx.update(g, s, p)
        return optax.apply_updates(p, updates), s

    for g in grads:
        jparams, jstate = apply(_tree([jnp.asarray(x) for x in g]), jstate, jparams)

    opt = topt.build_optimizer(topt.get_lr_schedule(**sched), **kw)
    params = {name: torch.from_numpy(x.copy()) for (name, _), x in zip(LEAVES.values(), init)}
    state = opt.init(params)
    applied = [opt.update(state, list(params.values()), [torch.from_numpy(x) for x in g])
               for g in grads]
    assert sum(applied) == 5 and state.count == 5
    for path, (name, _) in LEAVES.items():
        np.testing.assert_allclose(params[name].numpy(), _leaf(jparams, path), atol=1e-7, rtol=0,
                                   err_msg=name)
    if "mu_dtype" in kw:
        assert all(m.dtype == torch.bfloat16 for m in state.mu)


def test_wd_mask_matches_jax_on_the_model():
    bert = dict(vocab_size=50, hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
                intermediate_size=32, fusion_layer=1)
    vis = dict(img_size=32, patch_size=16, num_frames=2, embed_dim=16, depth=1, num_heads=2)
    jm = jax_build(JaxBertConfig(**bert), JaxVisCfg(**vis), img_size=32, num_frm=2)
    params = jax.jit(jm.init)({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 2, 32, 32, 3)),
                              jnp.zeros((1, 4), jnp.int32), jnp.ones((1, 4), jnp.int32))
    mask = jax.tree.map(lambda m, p: np.full(np.shape(p), m), jopt._wd_mask(params), params)
    want = {k: bool(v.all()) for k, v in _to_port_keys(alpro_state_dict(mask)).items()}
    port = build_retrieval_model(BertConfig(**bert), TimeSformerConfig(**vis), img_size=32,
                                 num_frm=2)
    got = {n: topt._wd_mask(n, p) for n, p in port.named_parameters()}
    assert got == want
    assert any(got.values()) and not all(got.values())
