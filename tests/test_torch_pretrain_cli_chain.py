"""The teacher workflow of ``tests/test_teacher_workflow.py`` through the
port's CLIs: prompter → pretraining → retrieval finetuning.

The port's ``run_prompter`` (4 steps on the fixture clips) writes
``model_step_4.pt``; ``run_pretrain`` (video + image, all four objectives)
reads it as ``teacher_weights_path`` and writes its deploy ``.pt``; both
packages' ``run_video_retrieval`` (``--do_inference 0``) finetune from that
``.pt`` as ``e2e_weights_path``, the MLM and MPM heads skipped. Held: the
port's finetune starts from the pretraining tensors bit for bit; the two
finetunes' losses and last parameters within atol 1e-5 and their R@k rows
equal; JAX's ``load_reference_checkpoint`` reads the port's pretraining
``.pt`` and the JAX model's forward on it (similarities, P(match), MLM and
MPM logits) agrees with the port's within 5e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import train_cli_fixtures as T
from alpro_tpu_torch.core.config import Config

SCORE_ATOL = 5e-4


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    from alpro_tpu_torch.cli import run_pretrain, run_prompter

    root = str(tmp_path_factory.mktemp("chain"))
    cfg = T.pretrain_cfg(root)
    prompter_out = os.path.join(root, "prompter")
    run_prompter.start_training(Config(dict(T.prompter_cfg(root), device="cpu",
                                            output_dir=prompter_out)))
    teacher = os.path.join(prompter_out, "ckpt", "model_step_4.pt")
    pretrain_out = os.path.join(root, "pretrain")
    run_pretrain.start_training(Config(dict(cfg, device="cpu", output_dir=pretrain_out,
                                            teacher_weights_path=teacher)))
    pretrained = os.path.join(pretrain_out, "ckpt", "model_step_8.pt")
    video = cfg["train_datasets"][0]
    spec = {"txt": video["ann"], "img": video["img"]}
    ret_cfg = T.toy_cfg(root, train_datasets=[spec], val_datasets=[spec],
                        e2e_weights_path=pretrained)
    starts = []
    from alpro_tpu_torch.cli import common

    merge = common.merge_state_dict

    def recording_merge(model, sd):
        out = merge(model, sd)
        starts.append(({k: v.detach().clone() for k, v in model.state_dict().items()}, out))
        return out

    common.merge_state_dict = recording_merge
    try:
        dirs = T.run_both("run_video_retrieval", ret_cfg, root, "finetune")
    finally:
        common.merge_state_dict = merge
    return dict(cfg=cfg, pretrained=pretrained, dirs=dirs, starts=starts)


def test_finetune_starts_from_the_pretraining_tensors(chain):
    from alpro_tpu_torch.checkpoint.load import _to_port_keys

    (start, merged), = chain["starts"]
    saved = _to_port_keys(torch.load(chain["pretrained"], weights_only=True))
    heads = [k for k in saved if k.startswith(("text_encoder.cls.", "mpm_head."))]
    assert heads and sorted(k.split(" ")[0] for k in merged["skipped"]) == sorted(heads)
    assert not merged["missing"]
    for k, v in start.items():
        assert torch.equal(v, saved[k]), k


def test_finetunes_match_jax(chain):
    T.check_run(chain["dirs"], 4, n_val_rows=3)


def test_jax_reads_the_port_pretraining_checkpoint(chain):
    from alpro_tpu.checkpoint.torch_convert import load_reference_checkpoint
    from alpro_tpu.core.config import Config as JaxConfig
    from alpro_tpu.cli import common as jax_common
    from alpro_tpu_torch.checkpoint.reference import (
        load_reference_checkpoint as port_load,
        merge_state_dict,
    )
    from alpro_tpu_torch.cli import common

    cfg = dict(chain["cfg"], mesh_shape=None)
    jcfg = JaxConfig(cfg)
    from alpro_tpu.models.scan_utils import unrolled_twin

    jm = unrolled_twin(jax_common.build_model_from_cfg(jcfg, "pretrain"))  # converted layout
    params, prompter = load_reference_checkpoint(chain["pretrained"], num_patches=4,
                                                 num_frames=2)
    assert not prompter and {"mlm_head", "mpm_hidden", "mpm_out"} <= set(params["params"])
    port = common.build_model_from_cfg(Config(dict(cfg, device="cpu")), "pretrain")
    merged = merge_state_dict(port, port_load(chain["pretrained"])[0])
    assert not merged["missing"] and not merged["skipped"]
    rng = np.random.RandomState(0)
    pixels = rng.randint(0, 256, (3, 2, 32, 32, 3)).astype(np.uint8)
    ids = rng.randint(5, 70, (3, 10)).astype(np.int32)
    mask = np.ones((3, 10), np.int32)
    mask[2, 6:] = 0
    want = jax.jit(jm.apply)(params, jnp.asarray(pixels), jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        got = port(torch.from_numpy(pixels), torch.from_numpy(ids), torch.from_numpy(mask))
    for k in ("sim", "itm_logits", "mlm_logits", "mpm_logits"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=SCORE_ATOL, rtol=0,
                                   err_msg=k)
