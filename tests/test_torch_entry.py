"""``alpro_tpu_torch/entry.py``: the multi-process dry run on two gloo
processes (one retrieval train step over dp, the sequence-parallel
attention against the unsplit one, a sharded index of 3 videos), and the
refusals: ``device='cuda'`` with fewer GPUs than processes raises and does
not run on the CPU instead; ``entry()`` needs a card."""

import pytest
import torch

from alpro_tpu_torch import entry


def test_dryrun_on_two_cpu_processes():
    report = entry.dryrun_multichip(2, device="cpu")
    assert report["loss"] > 0 and report["sp_gap"] <= 1e-4
    assert len(report["hits"]) == 3 and {h[0] for h in report["hits"]} <= {"v0", "v1", "v2"}
    assert "loss_2d" not in report  # the (n/2, 2) mesh needs n >= 4


def test_dryrun_refuses_missing_gpus(monkeypatch):
    import subprocess

    if torch.cuda.is_available() and torch.cuda.device_count() >= 2:
        pytest.skip("the refusal needs fewer than 2 GPUs")

    def no_spawn(*args, **kw):
        raise AssertionError("the dry run started processes")

    monkeypatch.setattr(subprocess, "Popen", no_spawn)
    with pytest.raises(RuntimeError, match="needs 2 GPUs"):
        entry.dryrun_multichip(2)
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        entry.dryrun_multichip(2, device="tpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry.entry()
