"""The port's data-parallel retrieval and QA steps on two gloo processes
against the JAX ``shard_step`` on a 2-device mesh, as
``tests/test_torch_dp_step.py`` holds the pretraining and prompter steps:
the toy retrieval model and the QA model (5 labels), fp32, dropout and
drop-path 0, global B = 2, one row a process (the hard-negative sampler has
one choice); every metric within atol 1e-5 and every gradient within 1e-4
of JAX's, the same on both processes. One spawn of
``tests/torch_dist_worker.py``.
"""

import pytest

import torch_dist_worker as W
from alpro_tpu.train import step as jax_step
from test_torch_dp_step import _batch, _check_both, _jax_global_step, _pair, _spawned


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases, want = {}, {}
    jm, params, port = _pair("retrieval", 1)
    batch = _batch(2)
    cases["retrieval"] = dict(kind="retrieval", make="retrieval", state=port.state_dict(),
                              batch=batch)
    want["retrieval"] = _jax_global_step(jax_step.make_retrieval_train_step, jm, params, batch)
    jm, params, port = _pair("qa", 3, num_labels=W.NUM_LABELS)
    batch = _batch(2, labels=[3, 1])
    cases["qa"] = dict(kind="qa", make="qa", state=port.state_dict(), batch=batch)
    want["qa"] = _jax_global_step(jax_step.make_qa_train_step, jm, params, batch)
    return _spawned(str(tmp_path_factory.mktemp("dp_step_tasks")), cases, want)


@pytest.mark.parametrize("case", ["retrieval", "qa"])
def test_two_processes_match_the_jax_global_step(runs, case):
    _check_both(runs, case)
