"""Faults planted underneath the timed path, to show that the comparison
that decides ``correct`` catches them. Each is a context manager that
patches the program for its duration; the benchmark's own runs plant none.

* ``frozen_state``: the optimizer step returns the state unchanged;
* ``half_batch``: the train step sees the first half of its rows only, its
  loss the mean over those;
* ``altered_tokens``: each ingested clip's patch tokens are stored one
  position off where the embedding produces them;
* ``altered_answers``: each query's candidates are paired with the ids in
  reversed order where the scores are produced."""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("frozen_state", "half_batch", "altered_tokens", "altered_answers")


@contextlib.contextmanager
def _patched(owner, name: str, make):
    original = getattr(owner, name)
    setattr(owner, name, make(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def planted(fault):
    """The context that plants ``fault`` (None: nothing)."""
    if fault is None:
        return contextlib.nullcontext()
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; known: {', '.join(FAULTS)}")
    if fault == "frozen_state":
        from alpro_tpu_torch.train.optimizer import AdamW

        return _patched(AdamW, "update", lambda orig: lambda self, state, params, grads: False)
    if fault == "half_batch":
        from alpro_tpu_torch.train.step import TrainStep

        def make(orig):
            def call(self, state, batch, seed=0, *extras):
                half = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
                return orig(self, state, half, seed, *extras)
            return call
        return _patched(TrainStep, "__call__", make)
    from alpro_tpu_torch.serving import retrieval

    if fault == "altered_tokens":
        def make(orig):
            def factory(model):
                embed = orig(model)

                def altered(pixels):
                    tokens, feat = embed(pixels)
                    return torch.cat([tokens[:, :1], tokens[:, 1:].roll(1, dims=1)], 1), feat
                return altered
            return factory
        return _patched(retrieval, "make_video_embed_fn", make)

    def make(orig):
        def score(self, texts, topk):
            probs, sims, idx = orig(self, texts, topk)
            return probs, sims, idx[:, ::-1]
        return score
    return _patched(retrieval.RetrievalIndex, "_score", make)
