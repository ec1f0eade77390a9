"""What a train step makes that a training cell's reference compares beside
its own, read where the step makes it: while a ``Recorder`` is open, the
functions that ``alpro_tpu_torch/train/step.py`` calls by name are wrapped,
and each call's inputs or outputs are kept (cloned; the step's arithmetic is
untouched).

* ``picks``: each hard-negative draw's return (``sample_hard_negatives``:
  this process's negative text and video indices);
* ``feats``: each VTC call's L2-normed video and text features
  (``vtc_loss``'s first two arguments);
* ``labels``: each teacher labelling's crop features, soft labels and
  ignore mask (``pseudo_labels_from_feats``'s first argument and return)."""

from __future__ import annotations

NAMES = ("sample_hard_negatives", "vtc_loss", "pseudo_labels_from_feats")


class Recorder:
    def __init__(self):
        self.picks, self.feats, self.labels = [], [], []

    def __enter__(self):
        from alpro_tpu_torch.train import step as train_step

        self._saved = [(train_step, n, getattr(train_step, n)) for n in NAMES]
        draw, vtc, label = (fn for _, _, fn in self._saved)

        def drawn(*args, **kwargs):
            out = draw(*args, **kwargs)
            self.picks.append(tuple(t.clone() for t in out))
            return out

        def contrasted(video_feat, text_feat, *args, **kwargs):
            self.feats.append((video_feat.detach().float().clone(),
                               text_feat.detach().float().clone()))
            return vtc(video_feat, text_feat, *args, **kwargs)

        def labelled(feat, bank, temp):
            soft, ignore = label(feat, bank, temp)
            self.labels.append({"feat": feat.float().clone(), "soft": soft.float().clone(),
                                "ignore": ignore.clone()})
            return soft, ignore

        for (module, name, _), fn in zip(self._saved, (drawn, contrasted, labelled)):
            setattr(module, name, fn)
        return self

    def __exit__(self, *exc):
        for module, name, fn in self._saved:
            setattr(module, name, fn)
