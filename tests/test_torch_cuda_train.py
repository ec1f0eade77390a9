"""The finetuning loop's device-side pieces, on the card.

Every test carries the ``cuda`` marker and skips without a CUDA device; the
file imports only torch and the port (no jax), so it runs on the machine
with the GPU: ``python -m pytest tests/test_torch_cuda_train.py -m cuda``.
The prefetcher's staging (pinned host memory, a copy on a side stream, the
consumer's stream made to wait and ``record_stream``) gives every batch
bit-equal to a pageable ``.to(device)`` copy over several steps while
other work allocates and frees device memory between them; an async resume
save holds the parameters as they were at ``save``, though the next step
changes them in place on the card at once.
"""

import numpy as np
import pytest
import torch
from torch import nn

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _host_batches(n):
    rng = np.random.default_rng(0)
    for _ in range(n):
        yield {"visual_inputs": rng.integers(0, 256, (8, 8, 224, 224, 3), dtype=np.uint8),
               "text_input_ids": rng.integers(0, 30522, (8, 40)).astype(np.int32),
               "question_ids": list(range(8))}


def test_prefetched_batches_equal_a_pageable_copy(cuda):
    from alpro_tpu_torch.data.loader import DevicePrefetcher, stage_batch

    side = torch.cuda.Stream(cuda)
    pf = DevicePrefetcher(_host_batches(6), lambda b: stage_batch(b, cuda, side), depth=2)
    want = list(_host_batches(6))
    try:
        for i, staged in enumerate(pf):
            # a step's worth of work on the current stream before and after the
            # batch is taken, allocating and freeing device memory
            busy = torch.randn(4096, 4096, device=cuda)
            for _ in range(4):
                busy = busy @ busy / 64
            batch = staged.wait()
            assert sorted(batch) == ["text_input_ids", "visual_inputs"]
            sums = {k: v.long().sum() for k, v in batch.items()}
            del busy
            scratch = [torch.empty(8 << 20, dtype=torch.uint8, device=cuda).fill_(7)
                       for _ in range(4)]
            for k, v in batch.items():
                ref = torch.from_numpy(want[i][k]).to(cuda)
                assert v.dtype == ref.dtype and torch.equal(v, ref), (i, k)
                assert int(sums[k]) == int(ref.long().sum()), (i, k)
            del scratch
        assert i == 5
    finally:
        pf.close()


def test_async_save_snapshots_before_the_next_step(cuda, tmp_path):
    from alpro_tpu_torch.checkpoint.restore import TrainingRestorer
    from alpro_tpu_torch.train.optimizer import build_optimizer, get_lr_schedule
    from alpro_tpu_torch.train.state import TrainState

    def state(seed):
        torch.manual_seed(seed)
        model = nn.Sequential(nn.Linear(1024, 4096), nn.Linear(4096, 1024)).to(cuda)
        return TrainState.create(model, build_optimizer(get_lr_schedule("constant", 1e-3, 10)))

    st = state(0)
    want = [p.detach().clone() for p in st.model.parameters()]
    restorer = TrainingRestorer(str(tmp_path), save_steps=1)
    restorer.save(st)
    with torch.no_grad():  # the next step, queued on the card right away
        for p in st.model.parameters():
            p.mul_(-3.0).add_(1.0)
    restorer.wait_until_finished()
    back = state(1)
    assert restorer.restore(back) is back
    for p, w in zip(back.model.parameters(), want):
        assert p.device.type == "cuda" and torch.equal(p, w)
    assert not torch.equal(next(st.model.parameters()), want[0])
