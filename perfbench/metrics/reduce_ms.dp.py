"""``reduce_ms.dp`` (ms): the mean host ms a micro-step inside rank 0's
``alpro.step.reduce``, the gradients' flat all-reduce and the metrics' sum
(``train/step.py``); read from the program's spans over the micro-steps
before the traced span (``lib/program.py``). Layer: collectives."""

from perfbench.lib.program import ms_per_step


def read(run, info):
    return ms_per_step(info, "alpro.step.reduce")
