"""``mlm_ms.pretrain`` (ms): the mean host ms a micro-step inside
``alpro.pretrain.mlm``: the masked text through the text half and the
fusion, the MLM head over the 30522-word vocabulary and its loss. Read from
the program's spans over the micro-steps before the traced span
(``lib/program.py``); None where the program has no such span. Layer: the
train step."""

from perfbench.lib.program import ms_per_step


def read(run, info):
    return ms_per_step(info, "alpro.pretrain.mlm")
