"""The pretraining step under ``attn_impl`` 'pallas' (the masked-attention
kernel's twin on the CPU, JAX's kernel in interpret mode) and with
objectives off, against alpro_tpu's, as in
``tests/test_torch_pretrain_steps.py``: metrics within atol 1e-5, every
gradient within 5e-5 of its own largest entry and 1e-5 of the whole
gradient's (the BERT key biases, whose true gradient is 0: the latter)."""

import pytest
import torch

from alpro_tpu.train import step as jax_step
from alpro_tpu_torch.train import step as port_step
from alpro_tpu_torch.train.state import TrainState
from test_torch_pretrain_steps import (GradTap, _batch, _check, _jax_step, _setup,
                                       check_pretrain_step)


def test_pretrain_step_under_pallas_matches_jax():
    check_pretrain_step("pallas")


def test_pretrain_step_subsets_and_checks():
    """MLM off, and MPM off (no teacher): the metrics that remain match
    JAX's; MPM without ITM or without a teacher raises."""
    (jm, params, port), _, _ = _setup()
    batch = _batch(1)
    for kw in (dict(use_mlm=False, use_mpm=False), dict(use_itc=False, use_mpm=False)):
        jmetrics, jgrads = _jax_step(jax_step.make_pretrain_train_step, jm, params, batch, **kw)
        tap = GradTap()
        _, pmetrics = port_step.make_pretrain_train_step(port, tap, **kw)(
            TrainState.create(port, tap), {k: torch.from_numpy(v) for k, v in batch.items()})
        _check(jmetrics, pmetrics, jgrads, tap.grads)
    with pytest.raises(ValueError, match="use_itm"):
        port_step.make_pretrain_train_step(port, GradTap(), use_itm=False, teacher=port)
    with pytest.raises(ValueError, match="teacher"):
        port_step.make_pretrain_train_step(port, GradTap())
