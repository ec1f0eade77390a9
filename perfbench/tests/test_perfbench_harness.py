"""The harness's plumbing on the CPU: files found by name, the open loop's
schedule and latency, the trace's arithmetic, the last line, the refusal
without a card, and ``correct`` against the planted faults and the control
at a tiny size."""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import time

import pytest

from perfbench.lib import harness
from perfbench.lib.faults import FAULTS, planted
from perfbench.lib.harness import ROOT, Check, load_cell, load_driver, load_reader, result_line
from perfbench.lib.spans import Spans
from perfbench.lib.trace import TraceRun, kernel_base_name
from perfbench.tests.tiny import ctx_for, tiny_cell

BENCH = json.loads((ROOT.parent / "BENCHMARK.json").read_text())


def _driver(name: str):
    return harness.load_module(ROOT / "drivers" / f"{name}.py")


# ---- files found by name -------------------------------------------------------------
def test_every_cell_of_the_benchmark_finds_its_files():
    for w in BENCH["workloads"]:
        cell = load_cell(w["name"])
        assert (ROOT / "drivers" / f"{cell.traffic['driver']}.py").is_file()
        assert cell.limits, w["name"]
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert callable(load_reader(m["name"]).read)


def test_a_new_config_traffic_cell_and_metric_are_found_without_editing(tmp_path):
    """A later change adds files and entries only: a copy of the harness with
    a new configuration, traffic mix, cell and reader finds each by name."""
    root = tmp_path / "perfbench"
    shutil.copytree(ROOT, root, ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = json.loads(json.dumps(BENCH))
    new_cfg = dict(json.loads((ROOT / "configs" / "alpro_base_ret.json").read_text()),
                   num_frm=32)
    (root / "configs" / "alpro_base_ret_t32.json").write_text(json.dumps(new_cfg))
    (root / "traffic" / "ingest_b8.json").write_text(json.dumps(
        dict(json.loads((ROOT / "traffic" / "ingest_b32.json").read_text()), clips_per_call=8)))
    (root / "cells" / "ret_ingest_t32.json").write_text(json.dumps(
        {"limits": {"feat_gap_mean": {"limit": 0.05}}}))
    (root / "metrics" / "calls.ingest.py").write_text(
        "def read(run, info):\n    return info.get('calls_traced')\n")
    bench["configs"].append({"name": "alpro_base_ret_t32", "source": "x",
                             "file": "perfbench/configs/alpro_base_ret_t32.json", "reduced": [],
                             "why": "x"})
    bench["workloads"].append({"name": "ret_ingest_t32", "config": "alpro_base_ret_t32",
                               "traffic": "ingest_b8", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "calls.ingest", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "serving",
                               "moves": "ingest_clips_per_s", "workloads": ["ret_ingest_t32"]})
    bench["end_to_end"][1]["workloads"].append("ret_ingest_t32")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = load_cell("ret_ingest_t32", root=root)
    assert cell.config["num_frm"] == 32 and cell.traffic["clips_per_call"] == 8
    assert cell.limits == {"feat_gap_mean": 0.05}
    assert [m["name"] for m in cell.per_layer] == ["calls.ingest"]
    assert load_reader("calls.ingest", root).read(None, {"calls_traced": 3}) == 3
    assert load_driver(cell.traffic, root).run.__name__ == "run"
    # the old cells are as they were
    assert load_cell("ret_ingest_b32", root=root).config["num_frm"] == 8


def test_an_unknown_cell_is_refused():
    with pytest.raises(harness.HarnessError):
        load_cell("no_such_cell")


# ---- the open loop -------------------------------------------------------------------
def test_arrivals_are_one_sample_path_at_the_rate():
    loop = _driver("open_loop")
    a = loop.arrivals(56.0, 30.0, 7)
    assert len(a) == 1680 and a[0] == 0.0 and a[-1] < 30.0
    assert (loop.arrivals(56.0, 30.0, 7) == a).all()
    gaps = a[1:] - a[:-1]
    assert abs(gaps.mean() - 1 / 56.0) < 1e-3
    assert 0.8 < gaps.std() / gaps.mean() < 1.1                 # exponential: CV 1
    assert not (loop.arrivals(56.0, 30.0, 8) == a).all()


def test_latency_is_taken_from_when_the_query_was_due():
    """A stall in one query delays those behind it, and their latency counts
    the wait; a query that fails counts as inf."""
    loop = _driver("open_loop")

    def call(i):
        if i == 0:
            time.sleep(0.2)
        if i == 3:
            raise RuntimeError("planted")

    lat, failed = loop.serve([0.0, 0.01, 0.02, 0.03, 0.3], call, Spans())
    assert failed == 1 and math.isinf(lat[3])
    assert lat[0] >= 0.2 and lat[1] >= 0.18 and lat[2] >= 0.17
    assert lat[4] < 0.1
    assert loop.p95(lat) == math.inf
    assert loop.p95([1.0] * 95 + [2.0] * 5) == 1.0
    assert loop.p50(lat) == sorted(lat)[2] and loop.p50([3.0, 1.0, 2.0, 9.0]) == 2.0
    tail = load_reader("latency_ms_p95.query")
    assert tail.read(None, {"latency_s": [0.001] * 95 + [0.002] * 5}) == 1.0
    assert tail.read(None, {"latency_s": lat}) == math.inf
    assert tail.read(None, {}) is None


# ---- the trace's arithmetic ----------------------------------------------------------
def test_kernel_names_and_busy_idle_arithmetic():
    assert kernel_base_name("void alpro::gemm::(anonymous namespace)::gemm_wgmma<1, 1, float>"
                            "(CUtensorMap_st)") == "gemm_wgmma"
    assert kernel_base_name("nvjet_tst_192x192_64x4_1x2_h_bz_coopB_bias_TNN") == \
        "nvjet_tst_192x192_64x4_1x2_h_bz_coopB_bias_TNN"
    run = TraceRun(window=(0.0, 100.0),
                   kernels=[("void gemm_wgmma<1>(int)", 10.0, 30.0),
                            ("ncclKernel_AllReduce", 20.0, 50.0),
                            ("elementwise_kernel", 60.0, 70.0)],
                   host=[("pb.step_fn", 0.0, 60.0), ("pb.add_videos", 5.0, 15.0)])
    assert run.window_s == pytest.approx(1e-4)
    assert run.busy_s == pytest.approx(50e-6)
    assert run.device_seconds({"gemm_wgmma"}) == pytest.approx(20e-6)
    assert run.gaps() == [(0.0, 10.0), (50.0, 60.0), (70.0, 100.0)]
    bd = run.breakdown()
    assert bd["device_ops"][0] == ["ncclKernel_AllReduce", pytest.approx(30e-6)]
    assert dict((k, v) for k, v in bd["idle_gaps"]) == {
        "step_fn": pytest.approx(20e-6), "outside_harness_spans": pytest.approx(30e-6)}


def test_every_reader_reads_nothing_from_nothing_and_a_share_below_100():
    info = {"chips": 1, "flop_per_clip": 1e9, "clips_untraced": 10, "seconds_untraced": 1.0,
            "calls_traced": 1, "clips_per_call": 32, "frames": 8, "outside_share": 0.01,
            "service_s": [0.01, 0.02], "latency_s": [0.02, 0.03], "flop_per_query": 1e9,
            "text_len": 40, "topk": 128, "queries_traced": 1}
    run = TraceRun(window=(0.0, 1e6), kernels=[("void gemm_wgmma<1>(int)", 0.0, 5e5)], host=[])
    for m in BENCH["per_layer"]:
        reader = load_reader(m["name"])
        assert reader.read(None, {}) is None, m["name"]
        value = reader.read(run, info)
        assert value is not None and value > 0, m["name"]
        if m["unit"] == "%":
            assert value <= 100.0, m["name"]


# ---- the last line -------------------------------------------------------------------
def test_the_last_line_has_the_contracts_keys():
    checks = [Check("feat_gap_mean", 0.01, 0.03), Check("token_gap_mean", math.inf, 0.02)]
    line = json.loads(result_line(False, 10, 1, {"setup_s": (12.5, "s")},
                                  {"platform": "gpu", "kind": "x", "count": 1,
                                   "memory_peak_bytes": 5}, checks, {"device_ops": [],
                                                                     "idle_gaps": []}))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["metrics"]["setup_s"] == {"value": 12.5, "unit": "s"}
    assert line["checks"]["token_gap_mean"] == {"value": "inf", "limit": 0.02}
    assert "breakdown" in line
    assert "breakdown" not in json.loads(result_line(True, 1, 0, {}, {}, checks[:1]))


def test_a_run_without_a_card_fails_and_prints_no_result():
    """No CUDA card: exit code 2, nothing on standard output; no CPU run."""
    out = subprocess.run([sys.executable, str(ROOT / "run.py"), "--workload", "ret_ingest_b32",
                          "--seed", str(2 ** 40 + 3), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=str(ROOT.parent))
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_a_checkout_without_the_program_fails_and_prints_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and the harness."""
    shutil.copytree(ROOT, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "ret_ingest_b32",
                          "--seed", "5", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=str(tmp_path))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


# ---- correct: the sound run, the faults, the control -----------------------------------
CELLS = {
    "ret_ingest_b32": lambda: tiny_cell("ret_ingest_b32", "alpro_base_ret", "ingest_b32",
                                        load_cell("ret_ingest_b32").limits, clips_per_call=4,
                                        check_clips=8),
    "ret_search_1k_k128": lambda: tiny_cell("ret_search_1k_k128", "alpro_base_ret",
                                            "search_1k_k128",
                                            load_cell("ret_search_1k_k128").limits, gallery=40,
                                            topk=8, ingest_per_call=8, rate_qps=20.0,
                                            check_queries=4),
    "qa_train_t16_b24": lambda: tiny_cell("qa_train_t16_b24", "alpro_base_qa",
                                          "finetune_msrvtt_qa",
                                          load_cell("qa_train_t16_b24").limits),
}
FAULTS_OF = {"ret_ingest_b32": ["altered_tokens"], "ret_search_1k_k128": ["altered_answers"],
             "qa_train_t16_b24": ["frozen_state", "half_batch"]}


def _run(cell_name: str, fault=None, control: bool = False):
    cell = CELLS[cell_name]()
    with planted(fault):
        out = load_driver(cell.traffic).run(ctx_for(cell, seconds=0.5, control=control))
    return out.checks


@pytest.mark.parametrize("cell_name", sorted(CELLS))
def test_the_sound_program_is_correct_at_a_tiny_size(cell_name):
    checks = _run(cell_name)
    assert checks and all(c.ok for c in checks), checks


@pytest.mark.parametrize("cell_name,fault", [(c, f) for c in sorted(FAULTS_OF)
                                             for f in FAULTS_OF[c]])
def test_a_planted_fault_makes_correct_false(cell_name, fault):
    assert fault in FAULTS
    checks = _run(cell_name, fault=fault)
    assert not all(c.ok for c in checks), checks


@pytest.mark.parametrize("cell_name", sorted(CELLS))
def test_the_fp8_control_reads_three_times_the_program(cell_name):
    """The reference in fp8 in the program's place: at this size as on the
    card, at least one compared number reads three times or more what the
    program's does."""
    sound = {c.name: c.value for c in _run(cell_name)}
    control = {c.name: c.value for c in _run(cell_name, control=True)}
    assert any(control[k] >= 3 * sound[k] for k in sound), (sound, control)
