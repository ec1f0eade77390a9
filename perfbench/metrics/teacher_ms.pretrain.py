"""``teacher_ms.pretrain`` (ms): the mean host ms a micro-step inside
``alpro.teacher``: the frozen teacher's no-grad forward of the erased crops
and its soft labels (``train/step.py::_teacher_pseudo_labels``). Read from
the program's spans over the micro-steps before the traced span
(``lib/program.py``); None where the program has no such span. Layer: the
train step."""

from perfbench.lib.program import ms_per_step


def read(run, info):
    return ms_per_step(info, "alpro.teacher")
