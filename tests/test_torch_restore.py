"""The port's resume checkpoints (``checkpoint/restore.py::TrainingRestorer``),
mirroring ``tests/test_restore_accum.py`` on the JAX restorer.

A two-layer module trained by the port's ``AdamW`` on a quadratic loss: a
restore puts the parameters, ``count``, ``mu``, ``nu`` (in their dtypes),
``mini_step``, ``acc`` and the step back bit for bit, so the run goes on
exactly as it would have; the a/b slots, their markers, async and sync
saves, the double buffer after a restore, a failed async write, and slots
that were never committed.
"""

import os

import pytest
import torch
from torch import nn

from alpro_tpu_torch.checkpoint import restore as restore_mod
from alpro_tpu_torch.checkpoint.restore import TrainingRestorer
from alpro_tpu_torch.train.optimizer import build_optimizer, get_lr_schedule
from alpro_tpu_torch.train.state import TrainState


def _state(accum=1, mu_dtype=None, nu_dtype=None, seed=0, step=0):
    torch.manual_seed(seed)
    model = nn.Sequential(nn.Linear(6, 8), nn.Linear(8, 3))
    opt = build_optimizer(get_lr_schedule("constant", 1e-2, 100), grad_norm=1.0,
                          accum_steps=accum, mu_dtype=mu_dtype, nu_dtype=nu_dtype)
    state = TrainState.create(model, opt)
    state.step = step
    return state, opt


def _step(state, opt, k):
    x = torch.linspace(-1, 1, 12).reshape(2, 6) * (k + 1)
    state.model.zero_grad(set_to_none=True)
    (state.model(x) ** 2).sum().backward()
    opt.update(state.opt_state, [p for p in state.model.parameters()],
               [p.grad for p in state.model.parameters()])
    state.step += 1


def _same(a: TrainState, b: TrainState):
    assert a.step == b.step
    for (n, p), (_, q) in zip(a.model.named_parameters(), b.model.named_parameters()):
        assert p.dtype == q.dtype and torch.equal(p, q), n
    sa, sb = a.opt_state, b.opt_state
    assert (sa.count, sa.mini_step) == (sb.count, sb.mini_step)
    for name in ("mu", "nu", "acc"):
        xs, ys = getattr(sa, name), getattr(sb, name)
        assert (xs is None) == (ys is None)
        for x, y in zip(xs or [], ys or []):
            assert x.dtype == y.dtype and torch.equal(x, y), name


def test_resume_mid_accumulation(tmp_path):
    """3 micro-steps of 2-step accumulation (one update, one gradient held),
    saved; the restored state equals it and its next micro-step gives the
    same parameters."""
    state, opt = _state(accum=2)
    for k in range(3):
        _step(state, opt, k)
    assert state.opt_state.mini_step == 1 and state.opt_state.count == 1
    restorer = TrainingRestorer(str(tmp_path), save_steps=1)
    restorer.save(state)
    restorer.wait_until_finished()
    fresh, fresh_opt = _state(accum=2, seed=1)
    assert TrainingRestorer(str(tmp_path)).restore(fresh) is fresh
    _same(fresh, state)
    _step(state, opt, 3)
    _step(fresh, fresh_opt, 3)
    _same(fresh, state)
    assert state.opt_state.count == 2


def test_resume_bf16_moments(tmp_path):
    """bf16 moments come back as bf16, bit for bit, and the run goes on the
    same (a sync save)."""
    state, opt = _state(mu_dtype="bfloat16", nu_dtype="bfloat16")
    for k in range(3):
        _step(state, opt, k)
    assert {m.dtype for m in state.opt_state.mu + state.opt_state.nu} == {torch.bfloat16}
    TrainingRestorer(str(tmp_path), async_save=False).save(state)
    fresh, fresh_opt = _state(mu_dtype="bfloat16", nu_dtype="bfloat16", seed=2)
    TrainingRestorer(str(tmp_path)).restore(fresh)
    _same(fresh, state)
    _step(state, opt, 3)
    _step(fresh, fresh_opt, 3)
    _same(fresh, state)
    other, _ = _state(seed=2)  # fp32 moments: the checkpoint does not fit
    with pytest.raises(ValueError, match="mu"):
        TrainingRestorer(str(tmp_path)).restore(other)


def test_async_save_newest_wins(tmp_path):
    restorer = TrainingRestorer(str(tmp_path), save_steps=1)
    assert restorer.async_save
    for step in (1, 2):
        restorer.save(_state(seed=step, step=step)[0])  # the second joins the first
    restorer.wait_until_finished()
    assert restorer.latest_slot() == "b"
    target = _state(seed=9)[0]
    assert restorer.restore(target).step == 2
    _same(target, _state(seed=2, step=2)[0])
    restorer.save(_state(seed=3, step=3)[0])  # overwrites slot a; restore joins it
    assert restorer.restore(_state(seed=9)[0]).step == 3


def test_sync_save_opt_out(tmp_path):
    restorer = TrainingRestorer(str(tmp_path), save_steps=1, async_save=False)
    restorer.save(_state(step=7)[0])
    assert restorer._pending is None and restorer.latest_slot() == "a"
    assert restorer.restore(_state(seed=5)[0]).step == 7


def test_post_restore_save_preserves_double_buffer(tmp_path):
    r1 = TrainingRestorer(str(tmp_path), save_steps=1, async_save=False)
    for step in (500, 1000, 1500):  # a, b, a
        r1.save(_state(step=step)[0])
    r2 = TrainingRestorer(str(tmp_path), save_steps=1, async_save=False)
    assert r2.restore(_state()[0]).step == 1500
    r2.save(_state(step=1600)[0])  # the older slot, b
    assert r2.latest_slot() == "b"
    with open(os.path.join(r2.dir, "a.done")) as f:
        assert int(f.read()) == 1500
    with open(os.path.join(r2.dir, "b.done")) as f:
        assert int(f.read()) == 1600
    assert r2.restore(_state()[0]).step == 1600


def test_failed_async_write_is_raised_at_the_join(tmp_path, monkeypatch):
    """The background write fails: no marker is written, and the error comes
    back at ``wait_until_finished`` (or the next save)."""
    restorer = TrainingRestorer(str(tmp_path), save_steps=1)
    monkeypatch.setattr(restore_mod.torch, "save",
                        lambda *a, **k: (_ for _ in ()).throw(OSError("disk full")))
    restorer.save(_state(step=1)[0])
    with pytest.raises(RuntimeError, match="async checkpoint save failed") as err:
        restorer.wait_until_finished()
    assert isinstance(err.value.__cause__, OSError)
    assert restorer.latest_slot() is None
    restorer.save(_state(step=2)[0])
    with pytest.raises(RuntimeError):
        restorer.save(_state(step=3)[0])


def test_uncommitted_slots_are_never_restored(tmp_path):
    """A slot without its marker — data cut mid-write, or a marker removed
    before an overwrite — is never read: no marker anywhere restores
    nothing, and a committed older slot wins over a newer partial one."""
    restorer = TrainingRestorer(str(tmp_path), save_steps=1, async_save=False)
    with open(os.path.join(restorer.dir, "a.pt"), "wb") as f:
        f.write(b"partial")
    target = _state(seed=4)[0]
    before = [p.clone() for p in target.model.parameters()]
    assert restorer.restore(target) is None
    assert all(torch.equal(p, q) for p, q in zip(target.model.parameters(), before))
    restorer.save(_state(step=10)[0])  # a, committed
    restorer.save(_state(step=20)[0])  # b, committed
    os.remove(os.path.join(restorer.dir, "b.done"))  # as save() does before overwriting b
    with open(os.path.join(restorer.dir, "b.pt"), "wb") as f:
        f.write(b"partial")
    assert restorer.latest_slot() == "a"
    assert TrainingRestorer(str(tmp_path)).restore(_state()[0]).step == 10


def test_async_save_snapshots_before_the_next_step(tmp_path, monkeypatch):
    """The write thread sees the state as it was at ``save``: a step that
    changes the parameters in place right after it does not reach the
    checkpoint (the write is held back until the step has run)."""
    import threading

    go = threading.Event()
    save = restore_mod.torch.save

    def held(*args, **kwargs):
        go.wait(timeout=30)
        return save(*args, **kwargs)

    monkeypatch.setattr(restore_mod.torch, "save", held)
    state, opt = _state(step=3)
    want = [p.detach().clone() for p in state.model.parameters()]
    restorer = TrainingRestorer(str(tmp_path), save_steps=1)
    restorer.save(state)
    _step(state, opt, 0)
    go.set()
    restorer.wait_until_finished()
    target = _state(seed=6)[0]
    restorer.restore(target)
    assert all(torch.equal(p, q) for p, q in zip(target.model.parameters(), want))
    assert not all(torch.equal(p, q) for p, q in zip(state.model.parameters(), want))
