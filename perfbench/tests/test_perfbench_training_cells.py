"""The pretraining cell's and the data-parallel cell's drivers at a tiny size
on the CPU (``pretrain_loop.py`` in this process; ``train_dp.py`` as 4 gloo
worker processes, and a run whose worker dies), ``correct`` against the
planted faults and the control, the window's schedule of the program's
spans, the nine readers those cells add, and the pretraining FLOP count.

At the tiny size, as at the published one, the random towers see every
prompt alike and the teacher's soft labels are uniform, so every MPM row is
ignored, and ``mpm_ignored_share`` reads 1 beside its limit of 1."""

from __future__ import annotations

import json
import math
import subprocess
import sys
import threading
import time

import pytest

from perfbench.counts import model as counts_model
from perfbench.counts import pretrain as counts_pretrain
from perfbench.counts import retrieval as counts_retrieval
from perfbench.lib import program
from perfbench.lib.faults import planted
from perfbench.lib.harness import FORBIDDEN, ROOT, load_cell, load_driver, load_reader
from perfbench.lib.trace import TraceRun
from perfbench.tests.tiny import ctx_for, tiny_cell

NEW_READERS = ("mfu.pretrain", "device_idle_pct.pretrain", "teacher_ms.pretrain",
               "mlm_ms.pretrain", "vtm_ms.pretrain", "mfu.dp", "device_idle_pct.dp",
               "comm_exposed_pct.dp", "reduce_ms.dp")


def pretrain_cell(**traffic):
    cell = tiny_cell("pretrain_t4_b64", "alpro_pretrain", "pretrain_webvid_cc3m",
                     load_cell("pretrain_t4_b64").limits,
                     pool_batches=2, **traffic)
    cell.config.update(train_batch_size=8, vtm_negative_blocks=2, num_entities=20)
    return cell


def dp_cell(**traffic):
    cell = tiny_cell("ret_train_dp4_b16", "alpro_base_ret", "finetune_msrvtt_ret_dp4",
                     load_cell("ret_train_dp4_b16").limits, pool_batches=3, timeout_s=240,
                     **traffic)
    cell.config.update(train_batch_size=8, vtm_negative_blocks=2)
    return cell


# ---- the pretraining cell ------------------------------------------------------------
@pytest.fixture(scope="module")
def sound_pretrain():
    cell = pretrain_cell()
    return load_driver(cell.traffic).run(ctx_for(cell, seconds=0.5))


def test_pretraining_sound_run_is_correct_at_a_tiny_size(sound_pretrain):
    checks = sound_pretrain.checks
    assert {c.name for c in checks} == {"loss_gap", "mlm_loss_gap",
                                        "first_grad_gap", "delta_gap", "teacher_feat_gap",
                                        "feat_gap", "mpm_ignored_share"}
    assert all(c.ok for c in checks), checks
    assert sound_pretrain.attempted > 0 and sound_pretrain.e2e["train_clips_per_s"] > 0


@pytest.mark.parametrize("fault", ["frozen_state", "half_batch"])
def test_pretraining_planted_fault_makes_correct_false(fault):
    cell = pretrain_cell()
    with planted(fault):
        out = load_driver(cell.traffic).run(ctx_for(cell, seconds=0.3))
    assert not all(c.ok for c in out.checks), out.checks


def test_pretraining_fp8_control_reads_three_times_the_program(sound_pretrain):
    cell = pretrain_cell()
    control = load_driver(cell.traffic).run(ctx_for(cell, control=True))
    sound = {c.name: c.value for c in sound_pretrain.checks}
    got = {c.name: c.value for c in control.checks}
    assert any(got[k] >= 3 * sound[k] for k in sound if sound[k] > 0), (sound, got)


def test_pretraining_spans_are_taken_before_the_trace_and_read(monkeypatch):
    """``--trace 1``'s schedule with the profiler stood in for: the spans
    are on for ``span_micro_steps`` micro-steps, drained before the tracer
    starts, none are recorded after; the span readers read them."""
    from alpro_tpu_torch.core import trace

    events = []

    class FakeTracer:
        def __init__(self, spans):
            self.host_s, self.stopped = 0.0, False

        def start(self):
            events.append(("start", trace._on))
            self.started_at = time.perf_counter()
            return self

        def stop(self):
            self.stopped_at = time.perf_counter()
            events.append(("stop", len(trace._store)))

        run = None

    monkeypatch.setattr(program, "Tracer", FakeTracer)
    cell = pretrain_cell(span_micro_steps=2, trace_micro_steps=1)
    ctx = ctx_for(cell, seconds=1.0)
    ctx.trace = True
    out = load_driver(cell.traffic).run(ctx)
    assert events == [("start", False), ("stop", 0)]
    spans = out.info["program"]["spans"]
    assert out.info["program"]["dropped"] == 0
    assert sum(s[0] == "alpro.step" for s in spans) == 2
    for name in ("teacher_ms.pretrain", "mlm_ms.pretrain", "vtm_ms.pretrain"):
        assert load_reader(name).read(None, out.info) > 0, name
    assert out.info["clips_untraced"] == (out.attempted - 1) * 8


def test_a_pretraining_run_loads_no_module_named_jax_or_alpro_tpu():
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT.parent)!r})
from perfbench.tests.test_perfbench_training_cells import pretrain_cell
from perfbench.lib.harness import load_driver
from perfbench.tests.tiny import ctx_for
cell = pretrain_cell()
load_driver(cell.traffic).run(ctx_for(cell, seconds=0.2))
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, check=True)
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "alpro_tpu_torch" in names and not names & set(FORBIDDEN)


# ---- the data-parallel cell ----------------------------------------------------------
def test_data_parallel_run_on_four_gloo_processes_is_correct():
    cell = dp_cell()
    out = load_driver(cell.traffic).launch(ctx_for(cell, seconds=1.0), 4)
    assert all(c.ok for c in out.checks), out.checks
    assert {c.name: c.value for c in out.checks}["rank_param_gap"] == 0.0
    assert out.attempted > 0 and out.e2e["train_clips_per_s"] > 0
    assert out.info["chips"] == 4
    assert out.info["clips_untraced"] == out.attempted * 8


@pytest.mark.parametrize("fault", ["frozen_state", "half_batch"])
def test_data_parallel_planted_fault_reaches_the_workers_and_makes_correct_false(fault):
    """Planted around the run as ``run.py --fault`` plants it: every worker
    plants it too, and the comparison catches it."""
    cell = dp_cell()
    with planted(fault):
        out = load_driver(cell.traffic).launch(ctx_for(cell, seconds=0.3), 4)
    assert not all(c.ok for c in out.checks), out.checks


def test_a_window_of_agreed_steps_closes_after_them_and_fits_the_trace():
    ctx = ctx_for(dp_cell(), seconds=1e6)
    window = program.Window(ctx, span_steps=4, trace_steps=2, lead=False, steps=3)
    assert window.steps == 4 + 2 + int(0.3 * 3)
    assert [window.after() for _ in range(window.steps)] == [False] * (window.steps - 1) + [True]
    assert program.Window(ctx, 4, 2, steps=100).steps == 100


def test_data_parallel_fp8_control_reads_three_times_the_program():
    cell = dp_cell()
    drv = load_driver(cell.traffic)
    sound = {c.name: c.value for c in drv.launch(ctx_for(cell, seconds=0.5), 2).checks}
    got = {c.name: c.value for c in drv.launch(ctx_for(cell, control=True), 2).checks}
    assert any(got[k] >= 3 * sound[k] for k in sound if sound[k] > 0), (sound, got)


def test_a_dead_worker_ends_the_data_parallel_run_within_its_timeout():
    """Worker 2 of 4 is killed once the workers are up: the run raises well
    inside its timeout and leaves no worker behind."""
    cell = dp_cell()
    started = {}

    def kill_one(procs):
        started["procs"] = procs
        threading.Timer(8.0, procs[2].kill).start()

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="worker 2 exited"):
        load_driver(cell.traffic).launch(ctx_for(cell, seconds=30.0), 4, on_started=kill_one)
    assert time.monotonic() - t0 < 60.0
    assert all(p.poll() is not None for p in started["procs"])


# ---- the readers and the counts ------------------------------------------------------
def _span(name, start, end, i, parent=None):
    return (name, start, end, i, parent, 1, 0)


def test_the_new_readers_read_nothing_from_nothing_and_their_spans_and_kernels():
    program_spans = [_span("alpro.step", 0.0, 1.0, 0), _span("alpro.step.reduce", 0.7, 0.75, 1, 0),
                     _span("alpro.teacher", 0.2, 0.23, 2, 0),
                     _span("alpro.pretrain.mlm", 0.3, 0.32, 3, 0),
                     _span("alpro.pretrain.vtm", 0.1, 0.15, 4, 0),
                     _span("alpro.step", 1.0, 2.0, 5), _span("alpro.step.reduce", 1.7, 1.8, 6, 5)]
    info = {"chips": 4, "flop_per_clip": 1e12, "clips_untraced": 100, "seconds_untraced": 10.0,
            "program": {"spans": program_spans, "dropped": 0}}
    run = TraceRun(window=(0.0, 100.0), kernels=[("void gemm_wgmma<1>(int)", 10.0, 30.0),
                                                 ("ncclDevKernel_AllReduce_Sum_f32", 20.0, 50.0),
                                                 ("elementwise_kernel", 60.0, 70.0)], host=[])
    want = {"mfu.pretrain": 100 * 1e14 / 10 / 4 / 989e12, "mfu.dp": 100 * 1e14 / 10 / 4 / 989e12,
            "device_idle_pct.pretrain": 50.0, "device_idle_pct.dp": 50.0,
            "comm_exposed_pct.dp": 20.0, "reduce_ms.dp": 75.0, "teacher_ms.pretrain": 15.0,
            "mlm_ms.pretrain": 10.0, "vtm_ms.pretrain": 25.0}
    for name in NEW_READERS:
        reader = load_reader(name)
        assert reader.read(None, {}) is None, name
        assert reader.read(run, info) == pytest.approx(want[name]), name
    dropped = dict(info, program={"spans": program_spans, "dropped": 3})
    assert load_reader("reduce_ms.dp").read(run, dropped) is None
    no_nccl = TraceRun(window=(0.0, 10.0), kernels=[("gemm", 0.0, 5.0)], host=[])
    assert load_reader("comm_exposed_pct.dp").read(no_nccl, info) is None
    hidden = TraceRun(window=(0.0, 10.0), kernels=[("gemm", 0.0, 10.0), ("ncclKernel", 2.0, 4.0)],
                      host=[])
    assert load_reader("comm_exposed_pct.dp").read(hidden, info) == 0.0
    assert load_reader("teacher_ms.pretrain").read(None, {"program": {
        "spans": [_span("alpro.step", 0.0, 1.0, 0)], "dropped": 0}}) is None


def test_every_new_metric_has_its_reader_and_only_its_cell():
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    metrics = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW_READERS:
        cell = "pretrain_t4_b64" if name.endswith(".pretrain") else "ret_train_dp4_b16"
        assert metrics[name]["workloads"] == [cell]
        assert metrics[name]["moves"] == "train_clips_per_s"
        assert callable(load_reader(name).read)


def test_pretraining_flop_count():
    """A clip at 4 frames and 30 tokens: the student's forward ≈ 0.283
    TFLOP (the tower 0.196, VTM's three fusion rows 0.061, MLM's second text
    half, fusion and 30522-word head 0.024), the teacher's 0.196; trained,
    3 × the student's + the teacher's ≈ 1.05 TFLOP."""
    student = counts_pretrain.student_forward(4, 30)
    teacher = counts_pretrain.teacher_forward(4)
    assert teacher == pytest.approx(counts_model.ingest_clip(4))
    assert student == pytest.approx(0.28327e12, rel=1e-4)
    assert teacher == pytest.approx(0.19577e12, rel=1e-4)
    assert counts_pretrain.pretrain_clip(4, 30) == pytest.approx(3 * student + teacher)
    head = 30 * (2 * 768 * 768 + 2 * 768 * 30522)
    assert counts_pretrain.student_forward(4, 30, vocab=1) == pytest.approx(
        student - 30 * 2 * 768 * 30521)
    assert head < 0.01 * student
    retrieval = counts_retrieval.retrieval_train_clip(8, 40)
    assert retrieval == pytest.approx(3 * (counts_model.ingest_clip(8)
                                           + counts_model.bert_layers(40, 6) + 2 * 768 * 256
                                           + 3 * (counts_model.bert_layers(237, 6) + 4 * 768)))
    assert math.isclose(retrieval / 1e12, 1.3757, rel_tol=1e-3)


def test_ms_per_step_needs_steps_and_the_span():
    info = {"program": {"spans": [_span("alpro.step", 0.0, 2.0, 0),
                                  _span("alpro.x", 0.5, 1.0, 1, 0)], "dropped": 0}}
    assert program.ms_per_step(info, "alpro.x") == pytest.approx(500.0)
    assert program.ms_per_step(info, "alpro.y") is None
    assert program.ms_per_step({}, "alpro.x") is None
