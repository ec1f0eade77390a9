"""A run's own checkpoints (the port's counterpart of
``alpro_tpu/checkpoint/orbax_io.py``), written with ``torch.save`` in the
ALPRO key space (``checkpoint/load.py``):

* deploy checkpoints — the model's parameters only,
  ``output_dir/ckpt/model_step_{N}.pt``: an ALPRO-key ``.pt`` that
  ``inference_model_step``, ``inference_model_ckpt`` and the JAX package's
  ``load_reference_checkpoint`` all read;
* resume checkpoints — the parameters, the whole ``AdamWState`` (``count``,
  ``mu`` and ``nu`` in their own dtypes, ``mini_step``, the accumulator
  ``acc``) and the step, double-buffered in ``output_dir/restore/{a,b}.pt``.

A slot's ``.done`` marker holds the step it saved. It is removed before the
slot's data is overwritten and written only after the data is committed (a
temporary name, then ``os.replace``), so a run cut anywhere leaves either
the old slot or the new one, never a marker over partial data; the newest
marker wins at restore, and a restore seeds the alternation so that the
next save overwrites the older slot. An async save copies the state to the
host at the save boundary, before the next step can change the parameters
in place, and a thread writes that snapshot; a failed write is raised again
at the next save or at ``wait_until_finished``.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

import torch

from alpro_tpu_torch.checkpoint.load import (
    _to_port_keys,
    alpro_state_dict_of,
    load_alpro_state_dict,
    to_alpro_keys,
)
from alpro_tpu_torch.core.logging import LOGGER
from alpro_tpu_torch.core.misc import retry_io
from alpro_tpu_torch.train.state import TrainState


def _commit(obj, path: str) -> None:
    """``torch.save`` to a temporary name, then ``os.replace`` onto ``path``."""
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _mark(path: str, step: int) -> None:
    """Write the marker ``path`` holding ``step`` (a temporary name, then
    ``os.replace``)."""
    with open(path + ".tmp", "w") as f:
        f.write(str(step))
    os.replace(path + ".tmp", path)


def _host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t`` that later in-place updates of ``t`` do not touch
    (the copy from a card has finished when this returns)."""
    return t.detach().to("cpu", copy=True)


def save_params(output_dir: str, step: int, model: torch.nn.Module) -> str:
    """Write the deploy checkpoint ``output_dir/ckpt/model_step_{step}.pt``
    (the model's parameters, ALPRO keys, on the CPU); returns its path."""
    path = os.path.abspath(os.path.join(output_dir, "ckpt", f"model_step_{step}.pt"))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    sd = {k: _host(v) for k, v in alpro_state_dict_of(model).items()}
    retry_io(lambda: _commit(sd, path), what=f"saving {path}")
    LOGGER.info("saved model checkpoint: %s", path)
    return path


def load_params(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Copy a deploy checkpoint's parameters into ``model`` (every key must
    match, ``checkpoint/load.py::load_alpro_state_dict``)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return load_alpro_state_dict(model, sd)


def _named(model, tensors: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
    return dict(zip((n for n, _ in model.named_parameters()), tensors))


def snapshot(state: TrainState) -> dict:
    """The resume state on the host: ``step``, the parameters and the
    optimizer's tensors by ALPRO key (moments in their own dtypes), its
    counters."""
    model, opt = state.model, state.opt_state
    return {
        "step": int(state.step),
        "params": {k: _host(v) for k, v in alpro_state_dict_of(model).items()},
        "count": int(opt.count),
        "mini_step": int(opt.mini_step),
        "mu": {k: _host(v) for k, v in to_alpro_keys(_named(model, opt.mu)).items()},
        "nu": {k: _host(v) for k, v in to_alpro_keys(_named(model, opt.nu)).items()},
        "acc": None if opt.acc is None else
        {k: _host(v) for k, v in to_alpro_keys(_named(model, opt.acc)).items()},
    }


def _restore_list(saved: Dict[str, torch.Tensor], like: List[torch.Tensor], model,
                  what: str) -> List[torch.Tensor]:
    """The saved tensors ``what`` in ``model.named_parameters()`` order, on
    the device of ``like``'s tensors, each with the dtype and shape of its
    counterpart in ``like`` (the optimizer this run built) or a raise."""
    port = _to_port_keys(saved)
    names = [n for n, _ in model.named_parameters()]
    if sorted(port) != sorted(names):
        raise KeyError(f"resume checkpoint: {what} names differ from the model's")
    out = []
    for name, ref in zip(names, like):
        t = port[name]
        if t.dtype != ref.dtype or t.shape != ref.shape:
            raise ValueError(f"resume checkpoint: {what} {name} is {t.dtype} {tuple(t.shape)}, "
                             f"the optimizer holds {ref.dtype} {tuple(ref.shape)}")
        out.append(t.to(ref.device))
    return out


class TrainingRestorer:
    """Preemption-safe resume: the state is written to ``restore/a.pt`` and
    ``restore/b.pt`` in turn every ``save_steps`` steps, and the newer
    committed slot wins at restore."""

    def __init__(self, output_dir: str, save_steps: int = 500, async_save: bool = True):
        self.dir = os.path.abspath(os.path.join(output_dir, "restore"))
        os.makedirs(self.dir, exist_ok=True)
        self.save_steps = save_steps
        self.async_save = bool(async_save)
        self._slot = 0
        self._pending: Optional[threading.Thread] = None
        self._pending_error: Optional[BaseException] = None

    def _join_pending(self) -> None:
        t, self._pending = self._pending, None
        if t is not None:
            t.join()
        if self._pending_error is not None:
            err, self._pending_error = self._pending_error, None
            raise RuntimeError("async checkpoint save failed") from err

    def wait_until_finished(self) -> None:
        """Block until an in-flight async save has committed (and raise its
        error, if it failed)."""
        self._join_pending()

    def due(self, global_step: int) -> bool:
        """Whether a resume checkpoint is due at this step; callers check
        this before copying the state to the host."""
        return self.save_steps > 0 and global_step % self.save_steps == 0

    def _write(self, snap: dict, path: str) -> None:
        _commit(snap, path + ".pt")
        _mark(path + ".done", snap["step"])

    def save(self, state: TrainState) -> None:
        slot = "a" if self._slot == 0 else "b"
        self._slot ^= 1
        path = os.path.join(self.dir, slot)
        # the marker goes before the data is touched: a run cut mid-write
        # falls back to the other slot, never to a stale marker
        try:
            os.remove(path + ".done")
        except FileNotFoundError:
            pass
        self._join_pending()  # one save in flight; the other slot is its target
        snap = snapshot(state)
        if not self.async_save:
            self._write(snap, path)
            return

        def write():
            try:
                self._write(snap, path)
            except BaseException as e:  # raised again at the next join
                self._pending_error = e

        self._pending = threading.Thread(target=write, daemon=True)
        self._pending.start()

    def latest_slot(self) -> Optional[str]:
        best, best_step = None, -1
        for slot in ("a", "b"):
            marker = os.path.join(self.dir, slot + ".done")
            if os.path.exists(marker):
                with open(marker) as f:
                    s = int(f.read().strip() or -1)
                if s > best_step:
                    best, best_step = slot, s
        return best

    def restore(self, state: TrainState) -> Optional[TrainState]:
        """Put the newest committed slot back into ``state`` (the model's
        parameters, the optimizer state and the step, every tensor bit for
        bit on the model's device) and return it; None, with ``state``
        untouched, when no slot is committed."""
        self._join_pending()
        slot = self.latest_slot()
        if slot is None:
            return None
        self._slot = 1 if slot == "a" else 0
        snap = torch.load(os.path.join(self.dir, slot + ".pt"), map_location="cpu",
                          weights_only=True)
        model, opt = state.model, state.opt_state
        if (snap["acc"] is None) != (opt.acc is None):
            raise ValueError("resume checkpoint: gradient accumulation differs from this run's")
        mu = _restore_list(snap["mu"], opt.mu, model, "mu")
        nu = _restore_list(snap["nu"], opt.nu, model, "nu")
        acc = None if opt.acc is None else _restore_list(snap["acc"], opt.acc, model, "acc")
        params = [p for _, p in model.named_parameters()]
        with torch.no_grad():
            for p, t in zip(params, _restore_list(snap["params"], params, model, "params")):
                p.copy_(t)
        opt.mu, opt.nu, opt.acc = mu, nu, acc
        opt.count, opt.mini_step = snap["count"], snap["mini_step"]
        state.step = snap["step"]
        LOGGER.info("restored the resume checkpoint %s.pt (step %d)", slot, state.step)
        return state
