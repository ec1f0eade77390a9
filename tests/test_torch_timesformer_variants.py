"""The port's joint and space-only TimeSformer and its three poolings vs
alpro_tpu's ``TimeSformer``.

Same weights (the JAX init with every leaf perturbed, carried over by the
port's ``checkpoint/from_jax.py``, which maps a block with no temporal
subtree), same numpy clips, fp32, within 2e-4 (docs/PARITY.md:151-170): in
eval on the plain path and with the kernels' twins (JAX's ``fused_qkv``
Pallas kernel in interpret mode against the port's K1 twin; the port's
joint block through K3's twin, ``mlp_impl='fused'``, where JAX's runs its
plain MLP), and in a training forward (dropout and drop-path rates 0, so
JAX's draws need no matching) with its gradient. Also: the ALPRO-key
round trip of such a tower, the visual-init converters filling it as JAX's
do, and the refusals of an unknown ``attention_type`` or ``pooling``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpro_tpu.models.timesformer import TimeSformer as JaxTimeSformer
from alpro_tpu.models.timesformer import TimeSformerConfig as JaxCfg
from alpro_tpu_torch.checkpoint.from_jax import timesformer_state_dict
from alpro_tpu_torch.checkpoint.load import load_alpro_state_dict, to_alpro_keys
from alpro_tpu_torch.models.timesformer import TimeSformer, TimeSformerConfig

ATOL = 2e-4
TOY = dict(img_size=32, patch_size=16, num_frames=3, embed_dim=32, depth=2, num_heads=4)
TYPES = ("joint_space_time", "space_only")
KERNELS = dict(attn_impl="fused_qkv", mlp_impl="fused")


def _pair(attention_type, impls=None, seed=0, **port_kw):
    jm = JaxTimeSformer(JaxCfg(**TOY, attention_type=attention_type, drop_path_rate=0.0,
                               **{k: v for k, v in (impls or {}).items() if k != "mlp_impl"}))
    params = jm.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, 3, 32, 32, 3)))
    rng = np.random.RandomState(seed)
    params = jax.tree.map(
        lambda x: x + np.float32(0.05) * np.asarray(rng.randn(*x.shape), np.float32), params)
    port = TimeSformer(TimeSformerConfig(**TOY, attention_type=attention_type,
                                         **(impls or {}), **port_kw))
    load_alpro_state_dict(port, timesformer_state_dict(params["params"], prefix=""))
    return jm, params, port


def _clips(seed, B=2):
    return np.random.RandomState(seed).randint(0, 256, (B, 3, 32, 32, 3)).astype(np.uint8)


@pytest.mark.parametrize("impls", [None, KERNELS], ids=["plain", "kernel_twins"])
@pytest.mark.parametrize("attention_type", TYPES)
def test_eval_matches_jax_under_every_pooling(attention_type, impls):
    jm, params, port = _pair(attention_type, impls)
    x = _clips(1)
    T = 1 if attention_type == "space_only" else 3
    shapes = {"temporal": (2, 5, 32), "spatial": (2, 1 + T, 32), "none": (2, T, 5, 32)}
    apply = jax.jit(jm.apply, static_argnames="pooling")
    for pooling, shape in shapes.items():
        want = np.asarray(apply(params, jnp.asarray(x), pooling=pooling))
        with torch.no_grad():
            got = port(torch.from_numpy(x), pooling=pooling).numpy()
        assert got.shape == want.shape == shape, (pooling, got.shape, want.shape)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0, err_msg=pooling)


@pytest.mark.parametrize("impls", [None, dict(attn_impl="fused_qkv")],
                         ids=["plain", "fused_qkv"])
@pytest.mark.parametrize("attention_type", TYPES)
def test_training_forward_and_gradient_match_jax(attention_type, impls):
    """deterministic=False with dropout and drop-path at 0: the training
    routes (``auto`` plain; ``fused_qkv`` K1's twin with K1's backward, the
    twin's vjp), their outputs and the gradient of sum(out²) per
    parameter; ``gradient_checkpointing`` on changes nothing (only the
    divided blocks are rematerialized, as in JAX)."""
    jm, params, port = _pair(attention_type, impls, seed=3, drop_path_rate=0.0,
                             gradient_checkpointing=True, remat_policy="dots_ln")
    x = _clips(2)

    def loss(p):
        out = jm.apply(p, jnp.asarray(x), deterministic=False)
        return jnp.sum(out ** 2), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    port.train()
    got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=ATOL, rtol=0)
    (got ** 2).sum().backward()
    want = timesformer_state_dict(jax.device_get(grads["params"]), prefix="")
    own = {k: p.grad for k, p in port.named_parameters()}
    own = to_alpro_keys({k: g for k, g in own.items() if g is not None})
    assert set(own) == set(want) - {"time_embed"} if attention_type == "space_only" else \
        set(own) == set(want)
    for k, g in own.items():
        np.testing.assert_allclose(g.numpy(), want[k], atol=1e-3, rtol=1e-3, err_msg=k)


@pytest.mark.parametrize("attention_type", TYPES)
def test_alpro_keys_round_trip_without_temporal_keys(attention_type):
    _, params, port = _pair(attention_type)
    sd = to_alpro_keys(port.state_dict())
    assert not [k for k in sd if "temporal" in k]
    assert set(sd) == set(timesformer_state_dict(params["params"], prefix=""))
    twin = TimeSformer(TimeSformerConfig(**TOY, attention_type=attention_type))
    load_alpro_state_dict(twin, sd)
    x = torch.from_numpy(_clips(4))
    with torch.no_grad():
        torch.testing.assert_close(twin(x), port(x), rtol=0, atol=0)
    divided = TimeSformer(TimeSformerConfig(**TOY))
    with pytest.raises(KeyError, match="temporal"):
        load_alpro_state_dict(divided, sd)


@pytest.mark.parametrize("attention_type, family", [
    ("joint_space_time", "imagenet"), ("space_only", "clip"), ("joint_space_time", "kinetics"),
    ("space_only", "kinetics")])
def test_visual_init_fills_the_tower_as_jax(tmp_path, attention_type, family):
    """The imagenet, CLIP and Kinetics converters (``checkpoint/visual_init.py``)
    read a joint or space-only tower's keys unchanged, the temporal ones
    skipped: the tower equals JAX's ``maybe_load_visual_weights`` on its
    own tree, and every block weight comes from the file."""
    from alpro_tpu.cli import common as jax_common
    from alpro_tpu.core.config import Config
    from alpro_tpu.models import BertConfig as JaxBertConfig
    from alpro_tpu.models.alpro import build_retrieval_model as jax_build
    from test_timesformer import random_vit_state_dict

    from alpro_tpu_torch.checkpoint.from_jax import alpro_state_dict
    from alpro_tpu_torch.checkpoint.load import alpro_state_dict_of, from_jax_params
    from alpro_tpu_torch.checkpoint.visual_init import load_visual_weights
    from alpro_tpu_torch.models.alpro import build_retrieval_model
    from alpro_tpu_torch.models.bert import BertConfig

    bert = dict(vocab_size=100, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                intermediate_size=64, fusion_layer=1)
    vis = dict(TOY, num_frames=2)
    sd = random_vit_state_dict(JaxCfg(**dict(vis, img_size=48, num_frames=4)),
                               np.random.RandomState(5))
    if family != "kinetics":
        sd = {k: v for k, v in sd.items() if "temporal" not in k and k != "time_embed"}
    path = str(tmp_path / {"imagenet": "vit_base_patch16_224.pt", "clip": "CLIP_ViT_B16.pt",
                           "kinetics": "timesformer_k600.pt"}[family])
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    jm = jax_build(JaxBertConfig(**bert), JaxCfg(**vis, attention_type=attention_type),
                   img_size=32, num_frm=2)
    params = jm.init({"params": jax.random.PRNGKey(1)}, jnp.zeros((1, 2, 32, 32, 3)),
                     jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32))
    port = build_retrieval_model(BertConfig(**bert),
                                 TimeSformerConfig(**vis, attention_type=attention_type),
                                 img_size=32, num_frm=2)
    from_jax_params(port, params)
    want = alpro_state_dict(jax.device_get(jax_common.maybe_load_visual_weights(
        params, Config(visual_weights_path=path, crop_img_size=32, num_frm=2))))
    load_visual_weights(port, path)
    got = alpro_state_dict_of(port)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    blk = "visual_encoder.model.blocks.1."
    np.testing.assert_array_equal(got[blk + "attn.qkv.weight"].numpy(),
                                  sd["blocks.1.attn.qkv.weight"])
    assert not [k for k in got if "temporal" in k]


def test_unknown_attention_type_and_pooling_raise():
    with pytest.raises(ValueError, match="attention_type"):
        TimeSformerConfig(**TOY, attention_type="divided")
    port = TimeSformer(TimeSformerConfig(**TOY, attention_type="space_only"))
    with pytest.raises(ValueError, match="pooling"):
        port(torch.from_numpy(_clips(0)), pooling="cls")
