"""The plain fp32 reference against ``alpro_tpu_torch``'s plain path at a tiny
size on the CPU, in fp32 (where the two compute the same mathematics, they
agree to fp32 rounding), and the rule that the benchmark loads neither JAX
nor the JAX package and that the reference imports nothing of the program.

The tests may import both; the reference itself may not."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.lib import port
from perfbench.lib.clips import planted_clips
from perfbench.lib.harness import FORBIDDEN, ROOT
from perfbench.lib.text import WORDS, captions
from perfbench.lib.weights import make_weights
from perfbench.reference import alpro as ref
from perfbench.reference import tokenizer as ref_tok
from perfbench.reference import train as ref_train
from perfbench.tests.tiny import tiny_config

CPU = torch.device("cpu")
SEED = 2 ** 35 + 11


def _fp32(name: str) -> dict:
    cfg = tiny_config(name)
    cfg["compute_dtype"] = "float32"
    return cfg


class _Ctx:
    """The part of a run's context that ``port.model_with_weights`` reads."""

    def __init__(self, cfg):
        self.cell = type("Cell", (), {"config": cfg})()
        self.device, self.seed = CPU, SEED

    def phase(self, name):
        pass


def _model(cfg):
    model, layout = port.model_with_weights(_Ctx(cfg))
    return model, ref.Net(make_weights(layout, SEED, CPU))


def _close(a, b, tol=2e-5):
    a, b = torch.as_tensor(a).float(), torch.as_tensor(b).float()
    assert torch.allclose(a, b, atol=tol, rtol=tol), float((a - b).abs().max())


def test_video_tower_and_feature_match_the_program():
    cfg = _fp32("alpro_base_ret")
    model, net = _model(cfg)
    px = planted_clips(SEED, 0, 3, cfg["num_frm"], cfg["crop_img_size"], CPU)
    with torch.no_grad():
        got = model.embed_video(px)
        want = ref.video_tokens(net, px, ref.vision_config(cfg))
        _close(got, want)
        _close(model.video_feat(got), ref.feature(net, want, "vision_proj"))


def test_text_fusion_and_match_probability_match_the_program():
    cfg = _fp32("alpro_base_ret")
    model, net = _model(cfg)
    texts = captions(np.random.SeedSequence(3), 4, 5, 20)
    enc = port.tokenizer()(texts, max_length=cfg["max_txt_len"])
    ids, mask = (torch.from_numpy(enc[k]).long() for k in ("input_ids", "attention_mask"))
    px = planted_clips(SEED, 5, 4, cfg["num_frm"], cfg["crop_img_size"], CPU)
    bcfg = cfg["model_config"]
    with torch.no_grad():
        text = model.embed_text(ids, mask)
        _close(text, ref.text_embeds(net, ids, mask, bcfg))
        _close(model.text_feat(text), ref.feature(net, text, "text_proj"))
        video = model.embed_video(px)
        fused = model.fuse(text, mask, video)
        _close(fused, ref.fusion(net, text, mask, video, bcfg))
        probs = torch.softmax(model.itm_logits(fused[:, 0]), dim=-1)[:, 1]
        _close(probs, ref.p_match(net, fused))


def test_qa_steps_match_the_programs_step_with_dropout_and_drop_path():
    """Three optimizer steps of two micro-steps: the program's train step
    and AdamW against the reference's, drawing the same masks from (seed,
    step): the losses, the first gradient and each parameter's change."""
    from alpro_tpu_torch.cli.common import setup_training
    from alpro_tpu_torch.core.config import Config
    from alpro_tpu_torch.train.step import make_qa_train_step

    cfg = _fp32("alpro_base_qa")
    model, _ = _model(cfg)
    layout = port.layout(model)
    run_cfg = Config(dict(cfg, seed=7, device="cpu", output_dir=None, e2e_weights_path=None))
    step, state, n_steps, _ = setup_training(run_cfg, model,
                                             lambda m, opt: make_qa_train_step(m, opt), 100)
    B, T, S = cfg["train_batch_size"], cfg["num_frm"], cfg["crop_img_size"]
    batches = []
    for i in range(6):
        enc = port.tokenizer()(captions(np.random.SeedSequence([4, i]), B, 5, 12),
                               max_length=cfg["max_txt_len"])
        batches.append({"visual_inputs": planted_clips(SEED, i * B, B, T, S, CPU),
                        "text_input_ids": torch.from_numpy(enc["input_ids"]),
                        "text_input_mask": torch.from_numpy(enc["attention_mask"]),
                        "labels": torch.arange(B) % cfg["num_labels"]})
    losses, first = [], None
    w0 = make_weights(layout, SEED, CPU)
    for b in batches:
        state, metrics = step(state, b, 7)
        losses.append(float(metrics["loss"]))
        if state.step == 2:
            first = {n: float(torch.linalg.vector_norm(m / 0.1))
                     for (n, _), m in zip(model.named_parameters(), state.opt_state.mu)}
    want = ref_train.qa_steps(w0, cfg, batches, 7, 3, -(-n_steps // 2))
    _close(losses, want["losses"], 1e-5)
    for n, v in want["first_grad"].items():
        assert abs(first[n] - v) <= 1e-4 * max(v, 1e-3), n
    for n, p in model.named_parameters():
        got = float(torch.linalg.vector_norm(p.detach() - w0[n]))
        assert abs(got - want["delta"][n]) <= 1e-3 * max(want["delta"][n], 1e-9), n


def test_reference_tokenizer_matches_the_programs():
    texts = captions(np.random.SeedSequence(9), 50, 1, 30) + ["Hello, WORLD! zyx qq's"]
    enc = port.tokenizer()(texts, max_length=40)
    ids, mask = ref_tok.encode(texts, ref_tok.vocab(WORDS), 40)
    np.testing.assert_array_equal(ids, enc["input_ids"])
    np.testing.assert_array_equal(mask, enc["attention_mask"])


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((ROOT / "reference").glob("*.py")):
        assert not _imports(path) & {"alpro_tpu_torch", *FORBIDDEN}, path.name


def test_no_file_the_benchmark_runs_imports_jax_or_the_jax_package():
    """Compared by whole top-level name: ``alpro_tpu_torch`` is not
    ``alpro_tpu``."""
    for path in sorted(ROOT.rglob("*.py")):
        if "tests" in path.relative_to(ROOT).parts:
            continue
        assert not _imports(path) & set(FORBIDDEN), path


@pytest.mark.parametrize("traffic", ["ingest_b32", "search_1k_k128", "finetune_msrvtt_qa"])
def test_a_run_loads_no_module_named_jax_or_alpro_tpu(traffic):
    """A tiny run of each driver in a fresh process, then the top-level
    names of ``sys.modules``, compared whole."""
    config = "alpro_base_qa" if traffic.startswith("finetune") else "alpro_base_ret"
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT.parent)!r})
from perfbench.lib.harness import load_driver
from perfbench.tests.tiny import ctx_for, tiny_cell
cell = tiny_cell("t", {config!r}, {traffic!r}, clips_per_call=2, check_clips=2, gallery=8,
                 topk=4, ingest_per_call=4, rate_qps=10.0, check_queries=2)
load_driver(cell.traffic).run(ctx_for(cell, seconds=0.3))
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, check=True)
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "alpro_tpu_torch" in names
    assert not names & set(FORBIDDEN)
