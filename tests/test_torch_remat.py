"""Every rematerialization policy of ``alpro_tpu_torch/models/remat.py``, as
``tests/test_grad_ckpt_accum.py`` holds JAX's: for the TimeSformer and for
BERT, per-block checkpointing under each of the nine policies gives the
outputs and the gradients of the same model without checkpointing, bit for
bit, with dropout and drop-path on (the recompute draws the forward's
masks) and on the masked-attention route (B13's twin, the kernel's custom
op on the CPU); with those rates at 0 both are within 1e-4 of JAX's
``jax.grad`` on the same weights. Also what each policy keeps, that the
names family reads the tagged outputs back (and B13's output in place of a
second call), and JAX's order of the names.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpro_tpu.models import BertConfig as JaxBertConfig
from alpro_tpu.models import BertModel as JaxBertModel
from alpro_tpu.models import TimeSformer as JaxTimeSformer
from alpro_tpu.models import TimeSformerConfig as JaxVisCfg
from alpro_tpu.models.remat import REMAT_POLICIES as JAX_POLICIES
from alpro_tpu_torch.checkpoint.from_jax import bert_state_dict, timesformer_state_dict
from alpro_tpu_torch.checkpoint.load import load_alpro_state_dict, to_alpro_keys
from alpro_tpu_torch.models import remat
from alpro_tpu_torch.models.bert import BertConfig, BertModel
from alpro_tpu_torch.models.timesformer import TimeSformer, TimeSformerConfig
from alpro_tpu_torch.ops import masked_attn

VIS = dict(img_size=32, patch_size=16, num_frames=2, embed_dim=16, depth=2, num_heads=2)
BERT = dict(vocab_size=50, hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=32, fusion_layer=1)
JAX_ATOL = 1e-4


@pytest.fixture(scope="module")
def towers():
    """JAX's TimeSformer and BERT (rates 0) with params, jax.grad of
    sum(out²) without checkpointing, and the inputs."""
    pixels = np.random.RandomState(0).rand(2, 2, 32, 32, 3).astype(np.float32)
    ids = np.random.RandomState(0).randint(0, 50, (2, 7))
    mask = np.ones((2, 7), np.int32)
    mask[1, 5:] = 0
    vm = JaxTimeSformer(JaxVisCfg(**VIS, drop_path_rate=0.0))
    vp = vm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(pixels))
    bm = JaxBertModel(JaxBertConfig(**BERT, hidden_dropout_prob=0.0,
                                    attention_probs_dropout_prob=0.0))
    bp = bm.init(jax.random.PRNGKey(0), input_ids=jnp.asarray(ids),
                 attention_mask=jnp.asarray(mask))

    def grads(f, p):
        out, g = jax.jit(jax.value_and_grad(lambda q: (lambda o: (jnp.sum(o ** 2), o))(f(q)),
                                            has_aux=True))(p)
        return np.asarray(out[1]), jax.device_get(g["params"])

    vout, vg = grads(lambda p: vm.apply(p, jnp.asarray(pixels)), vp)
    bout, bg = grads(lambda p: bm.apply(p, input_ids=jnp.asarray(ids),
                                        attention_mask=jnp.asarray(mask)), bp)
    return {"video": (vp, vout, timesformer_state_dict(vg, prefix=""), pixels),
            "text": (bp, bout, bert_state_dict(bg, prefix=""), (ids, mask))}


def _port(kind, towers, policy, rates, attn_impl):
    """The port's tower in training on JAX's weights; ``policy`` None: no
    checkpointing."""
    ckpt = dict(gradient_checkpointing=policy is not None, remat_policy=policy or "nothing")
    if kind == "video":
        drop = dict(drop_rate=0.1, drop_path_rate=0.1) if rates else dict(drop_path_rate=0.0)
        model = TimeSformer(TimeSformerConfig(**VIS, attn_impl=attn_impl, **drop, **ckpt))
        load_alpro_state_dict(model, timesformer_state_dict(towers["video"][0]["params"],
                                                            prefix=""))
    else:
        drop = {} if rates else dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
        model = BertModel(BertConfig(**BERT, attn_impl=attn_impl, **drop, **ckpt))
        load_alpro_state_dict(model, bert_state_dict(towers["text"][0]["params"], prefix=""))
    return model.train()


def _run(kind, model, towers, seed=7):
    """(output, {ALPRO key: gradient of sum(out²)}), masks from a seeded
    generator."""
    g = torch.Generator().manual_seed(seed)
    if kind == "video":
        out = model(torch.from_numpy(towers["video"][3]), g)
    else:
        ids, mask = towers["text"][3]
        out = model(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
                    mode="multi_modal", generator=g)
    (out ** 2).sum().backward()
    grads = {k: p.grad for k, p in model.named_parameters() if p.grad is not None}
    return out.detach(), to_alpro_keys(grads)


def test_policies_are_jaxs_in_jaxs_order():
    assert remat.REMAT_POLICIES == JAX_POLICIES
    for name in JAX_POLICIES:
        remat.resolve_remat_policy(name)
    with pytest.raises(ValueError, match="remat_policy"):
        remat.resolve_remat_policy("everything")
    with pytest.raises(ValueError, match="remat_policy"):
        TimeSformerConfig(remat_policy="dots_ln_name")


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
@pytest.mark.parametrize("kind", ["video", "text"])
def test_every_policy_keeps_output_and_gradients_with_dropout(kind, attn_impl, towers):
    ref_out, ref = _run(kind, _port(kind, towers, None, True, attn_impl), towers)
    assert max(float(g.abs().max()) for g in ref.values()) > 1e-3
    for policy in remat.REMAT_POLICIES:
        out, grads = _run(kind, _port(kind, towers, policy, True, attn_impl), towers)
        assert torch.equal(out, ref_out), policy
        assert grads.keys() == ref.keys(), policy
        for key, g in ref.items():
            assert torch.equal(grads[key], g), (policy, key)


@pytest.mark.parametrize("kind", ["video", "text"])
def test_every_policy_matches_jax(kind, towers):
    _, want_out, want, _ = towers[kind]
    for policy in remat.REMAT_POLICIES:
        out, grads = _run(kind, _port(kind, towers, policy, False, "xla"), towers)
        np.testing.assert_allclose(out.numpy(), want_out, atol=JAX_ATOL, rtol=0, err_msg=policy)
        assert set(grads) == set(want)
        for key, g in grads.items():
            np.testing.assert_allclose(g.numpy(), want[key], atol=JAX_ATOL, rtol=1e-4,
                                       err_msg=f"{policy} {key}")


def test_what_each_selective_policy_keeps(towers, monkeypatch):
    """The ops each policy keeps in the forward of the plain-path towers
    with dropout on."""
    aten = torch.ops.aten
    want = {"dots": {aten.mm.default, aten.addmm.default},
            "dots_all": {aten.mm.default, aten.addmm.default, aten.bmm.default},
            "dots_rng": {aten.mm.default, aten.addmm.default, aten.bernoulli.p},
            "dots_ln": {aten.mm.default, aten.addmm.default, aten.mean.dim}}
    for policy, ops in want.items():
        fn = getattr(remat, remat._SELECTIVE[policy])
        saved = set()

        def recording(ctx, op, *args, fn=fn, **kwargs):
            decision = fn(ctx, op, *args, **kwargs)
            if not ctx.is_recompute and decision.name == "MUST_SAVE":
                saved.add(op)
            return decision

        monkeypatch.setattr(remat, remat._SELECTIVE[policy], recording)
        for kind in ("video", "text"):
            _run(kind, _port(kind, towers, policy, True, "xla"), towers)
        assert {aten.addmm.default} <= saved <= ops, (policy, saved)
        assert policy == "dots" or saved & (ops - {aten.mm.default, aten.addmm.default}), policy


@pytest.mark.parametrize("policy", ["names", "dots_names", "dots_ln_names", "dots_ln_offload"])
@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
def test_names_keep_the_tags_and_b13s_output(policy, attn_impl, towers, monkeypatch):
    """Per checkpointed block the forward keeps one tensor per tag (two in
    a TimeSformer block, one in a BERT layer) and the recompute takes each
    back. On the masked-attention route the kept tensor of the spatial and
    the BERT tags is B13's output: its op runs once per block, where every
    other policy runs it again in the recompute."""
    kept, calls = [], []
    put, take = remat._Kept.put, remat._Kept.take
    monkeypatch.setattr(remat._Kept, "put", lambda self, t: (kept.append(1), put(self, t)))
    monkeypatch.setattr(remat._Kept, "take", lambda self, d: (kept.append(-1), take(self, d))[1])
    forward = masked_attn._forward
    monkeypatch.setattr(masked_attn, "_forward", lambda *a: (calls.append(1), forward(*a))[1])
    for kind, tags in (("video", 2), ("text", 1)):
        for name in (policy, "dots_ln"):
            kept.clear()
            calls.clear()
            _run(kind, _port(kind, towers, name, True, attn_impl), towers)
            blocks = 2
            if name == "dots_ln":
                assert not kept
                per_block = 2
            else:
                assert kept.count(1) == kept.count(-1) == tags * blocks, (kind, kept)
                per_block = 1
            if attn_impl == "pallas":
                assert len(calls) == per_block * blocks, (kind, name, calls)
