"""The pretraining model's heads, its checkpoint keys, the PEM/MLM
objectives and the visual-tower initializers against the JAX package.

Toy ALPRO (BERT hidden 32, 4 layers, fusion_layer 2, vocab 100; TimeSformer
D 32, depth 2, 32², T 2) with the JAX init perturbed on every leaf, loaded
into the port through ``from_jax_params``; fp32, eval mode. Held: the
forward with both heads (``mlm_logits``, ``mpm_logits``, sims, ITM) within
atol 2e-4; the objectives on the same numpy inputs within 1e-6; the MLM
decoder's bias read from either ALPRO key and written under both; and
``visual_init`` (timm/imagenet, CLIP, Kinetics) and the ALBEF e2e load equal
to the JAX converters' trees through ``checkpoint/from_jax.py``'s names, a
missing path warning and keeping the init.
"""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpro_tpu.models import BertConfig as JaxBertConfig
from alpro_tpu.models import TimeSformerConfig as JaxVisCfg
from alpro_tpu.models.alpro import build_pretrain_model as jax_build_pretrain
from alpro_tpu.objectives import mlm as jax_mlm
from alpro_tpu.objectives import pem as jax_pem
from alpro_tpu_torch.checkpoint.from_jax import alpro_state_dict
from alpro_tpu_torch.checkpoint.load import (
    alpro_state_dict_of,
    from_jax_params,
    load_alpro_state_dict,
)
from alpro_tpu_torch.models.alpro import build_pretrain_model, build_retrieval_model
from alpro_tpu_torch.models.bert import BertConfig
from alpro_tpu_torch.models.timesformer import TimeSformerConfig
from alpro_tpu_torch.objectives import mlm, pem

BERT = dict(vocab_size=100, hidden_size=32, num_hidden_layers=4, num_attention_heads=2,
            intermediate_size=64, fusion_layer=2)
VIS = dict(img_size=32, patch_size=16, num_frames=2, embed_dim=32, depth=2, num_heads=2)
B, L, E = 3, 8, 5
ACT_ATOL, OBJ_ATOL = 2e-4, 1e-6
_DEC = "text_encoder.cls.predictions."


def _randomized(params, seed):
    leaves, tree = jax.tree.flatten(params)
    rng = np.random.RandomState(seed)
    return jax.tree.unflatten(tree, [jnp.asarray(np.asarray(x) + np.asarray(
        0.05 * rng.randn(*np.shape(x)), np.float32)) for x in leaves])


@pytest.fixture(scope="module")
def models():
    jm = jax_build_pretrain(JaxBertConfig(**BERT), JaxVisCfg(**VIS), num_entities=E,
                            img_size=32, num_frm=2)
    params = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 2, 32, 32, 3)),
                     jnp.zeros((1, L), jnp.int32), jnp.ones((1, L), jnp.int32))
    params = _randomized(params, 1)
    port = build_pretrain_model(BertConfig(**BERT), TimeSformerConfig(**VIS), num_entities=E,
                                img_size=32, num_frm=2)
    from_jax_params(port, params)
    return jm, params, port


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    mask = np.ones((B, L), np.int32)
    mask[1, 5:] = 0
    return (rng.randint(0, 256, (B, 2, 32, 32, 3)).astype(np.uint8),
            rng.randint(1, 100, (B, L)).astype(np.int32), mask)


def test_forward_with_both_heads_matches_jax(models):
    jm, params, port = models
    pixels, ids, mask = _inputs()
    want = jax.jit(jm.apply)(params, jnp.asarray(pixels), jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        got = port(*(torch.from_numpy(x) for x in (pixels, ids, mask)))
    assert sorted(got) == sorted(want)
    assert got["mlm_logits"].shape == (B, L, 100) and got["mpm_logits"].shape == (B, E)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 or k.endswith("embeds") or k == "fusion", k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), atol=ACT_ATOL, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("head", ["mlm_logits", "mpm_logits"])
def test_head_alone_matches_jax(models, head):
    jm, params, port = models
    rng = np.random.RandomState(2)
    x = rng.randn(*((B, L, 32) if head == "mlm_logits" else (B, 32))).astype(np.float32)
    want = jm.apply(params, jnp.asarray(x), method=getattr(jm, head))
    with torch.no_grad():
        got = getattr(port, head)(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ACT_ATOL, rtol=0)


def test_pretrain_tree_maps_to_alpro_keys(models):
    _, params, port = models
    sd = alpro_state_dict(params)
    for k in (_DEC + "transform.dense.weight", _DEC + "transform.LayerNorm.weight",
              _DEC + "decoder.weight", _DEC + "decoder.bias", _DEC + "bias",
              "mpm_head.0.weight", "mpm_head.2.bias"):
        assert k in sd, k
    np.testing.assert_array_equal(sd[_DEC + "bias"], sd[_DEC + "decoder.bias"])
    assert sd[_DEC + "decoder.weight"].shape == (100, 32)  # its own tensor, not tied
    assert set(alpro_state_dict_of(port)) == set(sd)
    with pytest.raises(KeyError, match="no port module"):
        alpro_state_dict({"params": dict(params["params"], extra_head={})})


def test_mlm_bias_read_from_either_key(models):
    _, params, port = models
    sd = {k: torch.from_numpy(np.array(v)) for k, v in alpro_state_dict(params).items()}
    only_pred = dict(sd)
    only_pred[_DEC + "bias"] = only_pred.pop(_DEC + "decoder.bias") + 1.0
    other = build_pretrain_model(BertConfig(**BERT), TimeSformerConfig(**VIS), num_entities=E,
                                 img_size=32, num_frm=2)
    load_alpro_state_dict(other, only_pred)
    dec = other.text_encoder.cls.predictions.decoder
    torch.testing.assert_close(dec.bias.detach(), only_pred[_DEC + "bias"], rtol=0, atol=0)
    both = alpro_state_dict_of(other)
    torch.testing.assert_close(both[_DEC + "bias"], both[_DEC + "decoder.bias"], rtol=0, atol=0)
    load_alpro_state_dict(other, sd)  # both keys: decoder.bias wins
    torch.testing.assert_close(dec.bias.detach(), sd[_DEC + "decoder.bias"], rtol=0, atol=0)


# ---- objectives ----------------------------------------------------------------
def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=OBJ_ATOL, rtol=0)


def test_mlm_loss_matches_jax():
    rng = np.random.RandomState(0)
    logits = rng.randn(2, 6, 30).astype(np.float32) * 3
    labels = np.where(rng.rand(2, 6) < 0.4, rng.randint(0, 30, (2, 6)), -100).astype(np.int32)
    labels[0, 0] = 7
    _close(mlm.mlm_loss(torch.from_numpy(logits), torch.from_numpy(labels)),
           jax_mlm.mlm_loss(jnp.asarray(logits), jnp.asarray(labels)))
    none = np.full((2, 6), -100, np.int32)  # no labelled position: the count clamps to 1
    assert float(mlm.mlm_loss(torch.from_numpy(logits), torch.from_numpy(none))) == 0.0


def test_prompt_bank_matches_jax():
    rng = np.random.RandomState(1)
    total, n_ent = 3 * E, E
    ids = rng.randint(0, 50, (total, 7)).astype(np.int32)
    mask = (rng.rand(total, 7) < 0.8).astype(np.int32)
    w = rng.randn(7, 6).astype(np.float32)

    def enc_np(i, m, xp):
        f = (i * m).astype(xp.float32) @ xp.asarray(w)
        return f / xp.linalg.norm(f, axis=-1, keepdims=True)

    want = jax_pem.build_prompt_bank(lambda i, m: enc_np(i, m, jnp), jnp.asarray(ids),
                                     jnp.asarray(mask), n_ent, chunk_size=4)

    def enc_torch(i, m):
        f = (i * m).float() @ torch.from_numpy(w)
        return f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)

    got = pem.build_prompt_bank(enc_torch, torch.from_numpy(ids), torch.from_numpy(mask), n_ent,
                                chunk_size=4)
    assert got.shape == (n_ent, 6)
    _close(got, want)
    assert abs(float(torch.linalg.vector_norm(got, dim=-1).max()) - 1) > 1e-3  # not renormalized
    with pytest.raises(ValueError, match="multiple"):
        pem.build_prompt_bank(enc_torch, torch.from_numpy(ids[:-1]),
                              torch.from_numpy(mask[:-1]), n_ent)


def test_pseudo_labels_match_jax():
    rng = np.random.RandomState(2)
    feat = rng.randn(6, 8).astype(np.float32)
    bank = rng.randn(12, 8).astype(np.float32)
    for temp in (0.07, 20.0):  # sharp and flat: the rows ignored at the flat one
        soft, ignore = pem.pseudo_labels_from_feats(torch.from_numpy(feat),
                                                    torch.from_numpy(bank), torch.tensor(temp))
        jsoft, jignore = jax_pem.pseudo_labels_from_feats(jnp.asarray(feat), jnp.asarray(bank),
                                                          jnp.asarray(temp))
        _close(soft, jsoft)
        np.testing.assert_array_equal(ignore.numpy(), np.asarray(jignore))
    assert ignore.all()  # max prob < 0.2 at temperature 20


def test_masked_patch_mean_and_mpm_loss_match_jax():
    rng = np.random.RandomState(3)
    fusion = rng.randn(2, L + 1 + 4, 32).astype(np.float32)
    masks = np.ones((2, 2, 2), np.float32)
    masks[0, 0, :] = 0
    got = pem.masked_patch_mean(torch.from_numpy(fusion), torch.from_numpy(masks), L)
    want = jax_pem.masked_patch_mean(jnp.asarray(fusion), jnp.asarray(masks), L)
    _close(got, want)
    _close(got[1], np.zeros(32))  # nothing erased: the sum over a clamped count of 1
    logits = rng.randn(4, E).astype(np.float32)
    soft = np.array(jax.nn.softmax(jnp.asarray(rng.randn(4, E)), axis=1), np.float32)
    for ignore in ([False, True, False, False], [True] * 4):
        ig = np.asarray(ignore)
        _close(pem.mpm_loss(torch.from_numpy(logits), torch.from_numpy(soft), torch.from_numpy(ig)),
               jax_pem.mpm_loss(jnp.asarray(logits), jnp.asarray(soft), jnp.asarray(ig)))


# ---- visual-tower init ---------------------------------------------------------
def _vit_sd(seed, temporal, num_frames=2):
    from test_timesformer import random_vit_state_dict
    from alpro_tpu.models import TimeSformerConfig as Cfg

    sd = random_vit_state_dict(Cfg(img_size=48, patch_size=16, num_frames=num_frames,
                                   embed_dim=32, depth=2, num_heads=2),
                               np.random.RandomState(seed))
    if not temporal:
        sd = {k: v for k, v in sd.items() if "temporal" not in k and k != "time_embed"}
    return sd


def _port_retrieval(seed=0):
    from alpro_tpu_torch.models.alpro import init_random_

    model = build_retrieval_model(BertConfig(**BERT), TimeSformerConfig(**VIS), img_size=32,
                                  num_frm=2)
    return init_random_(model, torch.Generator().manual_seed(seed))


def _jax_tree_of(model):
    from alpro_tpu.checkpoint.torch_convert import convert_reference_state_dict

    return convert_reference_state_dict({k: v.numpy() for k, v in
                                         alpro_state_dict_of(model).items()})


def _assert_same(port_model, jax_params):
    want = alpro_state_dict(jax.device_get(jax_params))
    got = alpro_state_dict_of(port_model)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


@pytest.mark.parametrize("family", ["imagenet", "clip", "kinetics"])
def test_visual_init_matches_jax(tmp_path, family):
    """48² checkpoints (9 patches) into a 32² tower (4 patches), Kinetics at
    4 frames into 2: ``pos_embed``/``time_embed`` resized."""
    from alpro_tpu.cli import common as jax_common
    from alpro_tpu.core.config import Config
    from alpro_tpu_torch.checkpoint.visual_init import load_visual_weights

    sd = _vit_sd(4, temporal=family == "kinetics", num_frames=4)
    name = {"imagenet": "vit_base_patch16_224.pt", "clip": "CLIP_ViT_B16.pt",
            "kinetics": "timesformer_k600.pt"}[family]
    path = str(tmp_path / name)
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    if family == "kinetics":  # Kinetics files nest the tree under 'model' with a 'model.' prefix
        tensors = {"model": {"model." + k: v for k, v in tensors.items()}}
    torch.save(tensors, path)
    port = _port_retrieval()
    before = {k: v.clone() for k, v in alpro_state_dict_of(port).items()}
    want = jax_common.maybe_load_visual_weights(
        _jax_tree_of(port), Config(visual_weights_path=path, crop_img_size=32, num_frm=2))
    load_visual_weights(port, path)
    _assert_same(port, want)
    got = alpro_state_dict_of(port)
    blk = "visual_encoder.model.blocks."
    if family != "kinetics":
        torch.testing.assert_close(got[blk + "1.temporal_attn.qkv.weight"],
                                   torch.from_numpy(sd["blocks.1.attn.qkv.weight"]))
        assert not got[blk + "1.temporal_fc.weight"].any()
        torch.testing.assert_close(got[blk + "0.temporal_fc.weight"],
                                   before[blk + "0.temporal_fc.weight"], rtol=0, atol=0)
        torch.testing.assert_close(got["visual_encoder.model.time_embed"],
                                   before["visual_encoder.model.time_embed"], rtol=0, atol=0)
    else:
        torch.testing.assert_close(got["visual_encoder.model.time_embed"][0],
                                   torch.from_numpy(sd["time_embed"][0, [0, 2]]))


def test_albef_e2e_load_matches_jax(tmp_path):
    """An ALBEF checkpoint (plain ViT under ``visual_encoder.*``): spatial
    keys 1:1, temporal keys keep their init; auto-detected and with
    ``albef_init``."""
    from alpro_tpu.cli import common as jax_common
    from alpro_tpu.core.config import Config
    from alpro_tpu_torch.checkpoint.reference import load_reference_checkpoint, merge_state_dict

    donor = _port_retrieval(seed=9)
    sd = {k: v for k, v in alpro_state_dict_of(donor).items()
          if not k.startswith("visual_encoder.")}
    sd.update({"visual_encoder." + k: torch.from_numpy(v)
               for k, v in _vit_sd(6, temporal=False).items()})
    path = str(tmp_path / "albef_4m.pth")
    torch.save({"model": sd}, path)
    for flag in (False, True):
        port = _port_retrieval()
        before = {k: v.clone() for k, v in alpro_state_dict_of(port).items()}
        want = jax_common.maybe_load_e2e_weights(
            _jax_tree_of(port), Config(e2e_weights_path=path, crop_img_size=32, num_frm=2,
                                       albef_init=flag))
        loaded, _ = load_reference_checkpoint(path, num_patches=4, num_frames=2, albef=flag)
        merged = merge_state_dict(port, loaded)
        _assert_same(port, want)
        assert any("temporal_attn" in k for k in merged["missing"])
        got = alpro_state_dict_of(port)
        for k in got:
            if any(t in k for t in ("temporal", "time_embed")):
                torch.testing.assert_close(got[k], before[k], rtol=0, atol=0)


def test_visual_init_missing_path_warns_and_keeps_init(caplog):
    """The shipped pretraining configs' ``vit_base_patch16_224`` is no local
    file: ``setup_training`` warns and trains from the init."""
    from alpro_tpu_torch.cli import common
    from alpro_tpu_torch.core.config import Config
    from alpro_tpu_torch.train.step import make_prompter_train_step

    port = _port_retrieval()
    before = alpro_state_dict_of(port)
    cfg = Config(num_train_epochs=1, learning_rate=1e-4, visual_weights_path="vit_base_patch16_224")
    with caplog.at_level(logging.WARNING, logger="alpro_tpu_torch"):
        _, state, steps, _ = common.setup_training(cfg, port, make_prompter_train_step, 3)
    assert "not found" in caplog.text and not os.path.exists("vit_base_patch16_224")
    assert steps == 3 and state.step == 0
    for k, v in alpro_state_dict_of(port).items():
        assert torch.equal(v, before[k]), k
