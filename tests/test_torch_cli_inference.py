"""The port's inference CLIs against the JAX package's on the same ``.pt``.

Both packages' ``start_inference`` run on ``tests/fixtures.py`` data (clips
48 × 64, resized to 40 on the shorter side and center-cropped to 32) with
``inference_model_ckpt`` pointing at one ALPRO-key ``.pt`` written from JAX
params (``export_reference_state_dict`` + ``torch.save``, here only), fp32
compute, JAX on its XLA lowerings (its ``auto`` off the TPU), the port on the
CPU (``device='cpu'``, its plain twins). Tolerances: the ``results.json``
scores (P(match), the top-K band score or the VTC similarity) within 5e-4
(the parity gate's scores atol), the VTC similarities (cosines over the
temperature 0.07, up to ~14 in size) within 1e-3, QA pooled logits within
5e-4; the metrics equal exactly, or, where a score tie lies within the
tolerance, the port's ``eval_retrieval`` on JAX's results gives JAX's
metrics; QA answers equal wherever JAX's top-1 margin exceeds twice the
logit tolerance. Also the reference ``.pt`` loader (module resizes, the
prefix, the non-strict merge), the config parser on the shipped configs, and
the CLIs' refusals: ``--mesh_shape`` (ROADMAP A12), the ``remat_policy``
values that are not ported (A18), a pretraining model (A11), and the
``cuda`` default without a card.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from alpro_tpu.checkpoint.export_torch import save_torch_checkpoint
from alpro_tpu.core.config import Config as JaxConfig
from alpro_tpu.data.tokenization import make_test_vocab
from alpro_tpu.models.scan_utils import to_unrolled_layout
from alpro_tpu_torch.core.config import Config
from fixtures import write_multichoice_qa_dataset, write_qa_dataset, write_video_dataset

REPO = Path(__file__).resolve().parent.parent
SCORE_ATOL, SIM_ATOL, LOGIT_ATOL = 5e-4, 1e-3, 5e-4

BASE = {"attention_probs_dropout_prob": 0.0, "hidden_dropout_prob": 0.0, "hidden_size": 32,
        "intermediate_size": 64, "num_attention_heads": 4, "num_hidden_layers": 4,
        "vocab_size": 200, "max_position_embeddings": 64, "fusion_layer": 2, "pad_token_id": 0}
VIS = {"patch_size": 16, "embed_dim": 32, "depth": 2, "num_heads": 4, "drop_rate": 0,
       "attn_drop_rate": 0, "drop_path_rate": 0.0}


def _configs(root):
    paths = [os.path.join(root, n) for n in ("base_model.json", "vis_model.json", "vocab.txt")]
    for path, body in zip(paths[:2], (BASE, VIS)):
        with open(path, "w") as f:
            json.dump(body, f)
    with open(paths[2], "w") as f:
        f.writelines(tok + "\n" for tok in make_test_vocab())
    return paths


def _base_cfg(root, **kw):
    bm, vm, vocab = _configs(root)
    cfg = dict(model_config=bm, visual_model_cfg=vm, tokenizer_dir=vocab, max_txt_len=12,
               crop_img_size=32, resize_size=40, num_frm=2, inference_batch_size=4,
               val_batch_size=4, eval_video_batch_size=3, seed=42, compute_dtype="float32",
               do_inference=True, attn_impl="auto", n_workers=0, inference_txt_db=None,
               inference_img_db=None)
    cfg.update(kw)
    return cfg


def _export(cfg, task, root, seed):
    """JAX params of ``task``'s model at ``cfg`` → an ALPRO-key ``.pt``. The
    QA classifier's output layer is scaled by 100, so that the answers'
    logits stand apart by more than the tolerance."""
    from alpro_tpu.cli import common as jcommon

    model = jcommon.build_model_from_cfg(JaxConfig(cfg), task)
    params = jax.device_get(jcommon.init_params(model, JaxConfig(cfg), seed=seed))
    if task == "qa":
        out = params["params"]["classifier_out"]
        params["params"]["classifier_out"] = {k: np.asarray(v) * 100 for k, v in out.items()}
    path = os.path.join(root, f"{task}.pt")
    save_torch_checkpoint(path, to_unrolled_layout(params, model))
    return path


@pytest.fixture(scope="module")
def retrieval_setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ret"))
    ann, vid_dir, _ = write_video_dataset(root, n_videos=8, t=4, h=48, w=64)
    cfg = _base_cfg(root, val_datasets=[{"txt": ann, "img": vid_dir}])
    cfg["inference_model_ckpt"] = _export(cfg, "retrieval", root, seed=3)
    return root, cfg


def _run_both(module, cfg, root, name, results_file):
    """Both packages' ``start_inference`` of CLI ``module`` on ``cfg``:
    ((metrics, results) of JAX, of the port)."""
    import importlib

    out = []
    for pkg, config, extra in (("alpro_tpu", JaxConfig, {}),
                               ("alpro_tpu_torch", Config, {"device": "cpu"})):
        mod = importlib.import_module(f"{pkg}.cli.{module}")
        out_dir = os.path.join(root, name, pkg)
        metrics = mod.start_inference(config(dict(cfg, output_dir=out_dir, **extra)))
        with open(os.path.join(out_dir, results_file)) as f:
            saved = json.load(f)
        assert saved["metrics"] == json.loads(json.dumps(metrics))
        out.append((metrics, saved["results"]))
    return out


def _near_tie(results, gt, atol):
    """Whether some text's ground-truth score lies within ``atol`` of another
    video's score for that text (a rank the tolerance cannot decide)."""
    by_txt = {}
    for r in results:
        by_txt.setdefault(r["txt_id"], {})[r["vid_id"]] = r["score"]
    for t, row in by_txt.items():
        s = row[gt[t]]
        if any(abs(s - v) <= atol for vid, v in row.items() if vid != gt[t]):
            return True
    return False


@pytest.mark.parametrize("protocol", [{}, {"eval_rerank_topk": 2}, {"eval_vtc_only": True}],
                         ids=["k0", "topk2", "vtc_only"])
def test_retrieval_cli_matches_jax(retrieval_setup, protocol):
    from alpro_tpu_torch.evals.retrieval import eval_retrieval

    root, cfg = retrieval_setup
    name = "_".join(f"{k}{v}" for k, v in protocol.items()) or "k0"
    (jm, jr), (pm, pr) = _run_both("run_video_retrieval", dict(cfg, **protocol), root, name,
                                   "results.json")
    assert len(pr) == len(jr) == 8 * 8
    assert [(r["vid_id"], r["txt_id"]) for r in pr] == [(r["vid_id"], r["txt_id"]) for r in jr]
    np.testing.assert_allclose([r["score"] for r in pr], [r["score"] for r in jr],
                               atol=SCORE_ATOL, rtol=0)
    np.testing.assert_allclose([r["sim"] for r in pr], [r["sim"] for r in jr],
                               atol=SIM_ATOL, rtol=0)
    if pm != jm:
        gt = {i: f"vid{i:03d}" for i in range(8)}
        assert _near_tie(jr, gt, 2 * SCORE_ATOL), (pm, jm)
        assert eval_retrieval(jr, gt) == jm


def _capture_pooled(monkeypatch, module):
    """Record the pooled logits that ``module``'s ``inference_qa`` argmaxes."""
    seen = []
    pool = module.pool_clip_logits

    def recording(logits, method="mean"):
        out = pool(logits, method)
        seen.append(np.asarray(out))
        return out

    monkeypatch.setattr(module, "pool_clip_logits", recording)
    return seen


@pytest.mark.parametrize("task", ["open_ended", "multi_choice"])
def test_qa_cli_matches_jax(tmp_path, monkeypatch, task):
    """Open-ended MSVD-QA style with ``inference_n_clips`` 2 (a 4-frame stack
    as 2 clips of 2, mean-pooled), and TGIF-action style multi-choice (3
    options, ``num_labels`` forced to 1)."""
    import alpro_tpu.cli.run_video_qa as jqa
    import alpro_tpu_torch.cli.run_video_qa as pqa

    root = str(tmp_path)
    if task == "open_ended":
        ann, vid_dir, rows, ans2label = write_qa_dataset(root, n=6, t=4, h=48, w=64)
        a2l = os.path.join(root, "ans2label.json")
        with open(a2l, "w") as f:
            json.dump(ans2label, f)
        extra = dict(task="msvd_qa", ans2label_path=a2l, num_labels=len(ans2label),
                     inference_n_clips=2, score_agg_func="mean")
    else:
        ann, vid_dir, rows = write_multichoice_qa_dataset(root, n=6, t=2, h=48, w=64,
                                                          n_options=3)
        # 40 tokens: the question alone ("happening" spelled out) fills 11
        extra = dict(task="action", n_options=3, num_labels=1500, inference_n_clips=1,
                     score_agg_func="mean", max_txt_len=40)
    cfg = _base_cfg(root, val_datasets=[{"txt": ann, "img": vid_dir}], cls_hidden_scale=2,
                    **extra)
    if task == "multi_choice":
        cfg["num_labels"] = 1  # the JAX export needs the model the CLI forces
    cfg["inference_model_ckpt"] = _export(cfg, "qa", root, seed=5)
    if task == "multi_choice":
        cfg["num_labels"] = 1500
    seen_j, seen_p = _capture_pooled(monkeypatch, jqa), _capture_pooled(monkeypatch, pqa)
    (jm, jr), (pm, pr) = _run_both("run_video_qa", cfg, root, task, "qa_results.json")
    assert [r["question_id"] for r in pr] == [r["question_id"] for r in jr] == \
        [r["question_id"] for r in rows]
    got, want = np.concatenate(seen_p), np.concatenate(seen_j)
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)
    top2 = np.sort(want, axis=-1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > 2 * LOGIT_ATOL
    assert decided.any()
    for ok, p, j in zip(decided, pr, jr):
        if ok:
            assert p["answer"] == j["answer"]
    if decided.all():
        assert pm == jm


def test_cli_main_runs_on_the_cpu(retrieval_setup, tmp_path):
    """``python -m alpro_tpu_torch.cli.run_video_retrieval --config ...
    --do_inference 1 --device cpu`` in a fresh interpreter writes the
    metrics of ``start_inference`` on the same config."""
    _, cfg = retrieval_setup
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(dict(cfg, do_inference=0)))
    out = tmp_path / "out"
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    run = subprocess.run(
        [sys.executable, "-m", "alpro_tpu_torch.cli.run_video_retrieval", "--config", str(path),
         "--do_inference", "1", "--device", "cpu", "--output_dir", str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    from alpro_tpu_torch.cli.run_video_retrieval import start_inference

    want = start_inference(Config(dict(cfg, device="cpu", output_dir=str(tmp_path / "direct"))))
    assert json.loads((out / "results.json").read_text())["metrics"] == want


def test_cli_refusals(retrieval_setup, tmp_path):
    """``--mesh_shape`` names ROADMAP A12 (an argparse error), a
    ``remat_policy`` that is not ported A18, a pretraining model A11, and
    the default device is ``cuda``: with no card the CLI raises unless
    ``device='cpu'``."""
    from alpro_tpu_torch.cli import common, run_video_qa, run_video_retrieval
    from alpro_tpu_torch.core import config as pcfg

    _, cfg = retrieval_setup
    for mod in (run_video_retrieval, run_video_qa):
        with pytest.raises(SystemExit):
            mod.main(["--config", cfg["model_config"], "--device", "cpu", "--mesh_shape", "1",
                      "4"])
    with pytest.raises(SystemExit):
        pcfg.get_video_retrieval_args(["--remat_policy", "everything"])
    for name in ("dots", "dots_all", "dots_rng", "names", "dots_names", "dots_ln_names",
                 "dots_ln_offload"):
        assert pcfg.get_video_retrieval_args(["--remat_policy", name])["remat_policy"] == name
        with pytest.raises(ValueError, match="A18"):
            common.build_model_from_cfg(Config(dict(cfg, device="cpu", remat_policy=name)),
                                        "retrieval")
    with pytest.raises(NotImplementedError, match="A12"):
        common.setup_training(Config(dict(cfg, mesh_shape=[2])), None, None, 1)
    pretrain = common.build_model_from_cfg(Config(dict(cfg, device="cpu", num_entities=7)),
                                           "pretrain")
    assert pretrain.cfg.with_mlm_head and pretrain.mpm_head[2].out_features == 7
    assert pretrain.text_encoder.cls.predictions.decoder.out_features == \
        pretrain.cfg.bert.vocab_size
    assert not common.build_model_from_cfg(Config(dict(cfg, device="cpu")),
                                           "prompter").cfg.with_mlm_head
    assert Config(cfg).get("device") is None
    if torch.cuda.is_available():
        assert common.resolve_device(Config(cfg)).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_video_retrieval.start_inference(Config(dict(cfg, output_dir=str(tmp_path))))
    assert common.resolve_device(Config(dict(cfg, device="cpu"))).type == "cpu"


@pytest.mark.parametrize("name,parser", [("msrvtt_ret.json", "get_video_retrieval_args"),
                                         ("msrvtt_qa.json", "get_video_qa_args"),
                                         ("pretrain_alpro.json", "get_pretraining_args"),
                                         ("pretrain_prompter.json", "get_pretraining_args")])
def test_shipped_configs_parse_as_in_jax(name, parser):
    """``configs/msrvtt_{ret,qa}.json`` and ``configs/pretrain_{alpro,
    prompter}.json`` parse unchanged: every key of the
    port's result has JAX's value, but ``device='cuda'`` and the keys that
    the JAX CLIs read from a config file only, which the port declares with
    the JAX CLIs' defaults; the keys it leaves out are JAX's flags that
    nothing reads or that are TPU-only, and such a flag on the command line
    is refused, not ignored (``--mesh_shape`` with ROADMAP A12)."""
    import alpro_tpu.core.config as jcfg
    import alpro_tpu_torch.core.config as pcfg

    argv = ["--config", str(REPO / "configs" / name)]
    want = dict(getattr(jcfg, parser)(argv))
    got = dict(getattr(pcfg, parser)(argv))
    assert got.pop("device") == "cuda"
    config_keys = set(json.loads((REPO / "configs" / name).read_text()))
    defaults = {"apply_weight_decay": 0, "prefetch_depth": 2, "vtm_negative_blocks": 1,
                "prompt_chunk_size": 512, "num_val_batches": 2}
    for key, value in defaults.items():
        if key not in config_keys and key in got:
            assert key not in want and got.pop(key) == value
    assert got == {k: want[k] for k in got}
    assert config_keys <= set(got)
    assert {"learning_rate", "profile", "remat_policy", "num_train_epochs", "log_interval",
            "train_datasets", "frm_sampling_strategy"} <= set(got)
    dropped = {"xla_compiler_options", "scan_blocks", "num_workers", "dropout"} - config_keys
    assert dropped and dropped <= set(want) - set(got)
    for flag in (["--mesh_shape", "1", "4"], ["--xla_compiler_options", "a=b"],
                 ["--scan_blocks", "0"]):
        with pytest.raises(SystemExit):
            getattr(pcfg, parser)(argv + flag)
    for flag, key, value in ((["--profile", "1"], "profile", 1),
                             (["--learning_rate", "1e-4"], "learning_rate", 1e-4)):
        assert getattr(pcfg, parser)(argv + flag)[key] == getattr(jcfg, parser)(argv + flag)[key] \
            == value


def test_reference_checkpoint_loader(tmp_path):
    """Module 12: the 1-D nearest resizes equal the JAX converter's; a bare
    ``text_encoder.*`` BERT, a ``{"model": ...}`` wrapper and a
    ``prompter.*`` teacher are read; the merge skips unknown and mis-shaped
    keys and leaves the keys the file lacks at their values."""
    from alpro_tpu.checkpoint import torch_convert
    from alpro_tpu_torch.checkpoint import reference
    from alpro_tpu_torch.checkpoint.load import alpro_state_dict_of
    from alpro_tpu_torch.models.alpro import build_retrieval_model
    from alpro_tpu_torch.models.bert import BertConfig
    from alpro_tpu_torch.models.timesformer import TimeSformerConfig

    rng = np.random.default_rng(0)
    pos, time_ = rng.standard_normal((1, 1 + 196, 8)), rng.standard_normal((1, 8, 8))
    for n in (4, 16, 100, 196, 300):
        np.testing.assert_array_equal(
            reference.resize_spatial_embedding(torch.from_numpy(pos), n).numpy(),
            torch_convert.resize_spatial_embedding(pos, n))
    for t in (1, 4, 8, 16, 5):
        np.testing.assert_array_equal(
            reference.resize_temporal_embedding(torch.from_numpy(time_), t).numpy(),
            torch_convert.resize_temporal_embedding(time_, t))

    bert = BertConfig(**{k: BASE[k] for k in ("hidden_size", "intermediate_size",
                                              "num_attention_heads", "num_hidden_layers",
                                              "vocab_size", "max_position_embeddings",
                                              "fusion_layer")})
    vis = TimeSformerConfig(img_size=32, num_frames=2, embed_dim=32, depth=2, num_heads=4)
    src = build_retrieval_model(bert, TimeSformerConfig(img_size=48, num_frames=4, embed_dim=32,
                                                        depth=2, num_heads=4))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in src.parameters():
            p.normal_(generator=g)
    sd = alpro_state_dict_of(src)
    bare = {("text_encoder." + k[len("text_encoder.bert."):]
             if k.startswith("text_encoder.bert.") else k): v for k, v in sd.items()}
    bare.pop("itm_head.bias")
    bare["itm_head.weight"] = torch.zeros(3, 32)            # mis-shaped: skipped
    bare["mpm_head.0.weight"] = torch.zeros(2, 2)           # not in the model: skipped
    bare["prompter.temp"] = torch.tensor(9.0)
    path = tmp_path / "ref.pt"
    torch.save({"model": bare}, path)

    loaded, prompter = reference.load_reference_checkpoint(str(path), num_patches=4,
                                                           num_frames=2)
    assert list(prompter) == ["temp"]
    assert "text_encoder.bert.embeddings.word_embeddings.weight" in loaded
    np.testing.assert_array_equal(
        loaded["visual_encoder.model.pos_embed"].numpy(),
        torch_convert.resize_spatial_embedding(sd["visual_encoder.model.pos_embed"].numpy(), 4))
    np.testing.assert_array_equal(
        loaded["visual_encoder.model.time_embed"].numpy(),
        torch_convert.resize_temporal_embedding(sd["visual_encoder.model.time_embed"].numpy(), 2))

    dst = build_retrieval_model(bert, vis)
    before = {k: v.clone() for k, v in dst.state_dict().items()}
    report = reference.merge_state_dict(dst, loaded)
    assert sorted(report["skipped"]) == ["itm_head.weight (shape (3, 32) vs (2, 32))",
                                         "mpm_head.0.weight (not in model)"]
    assert report["missing"] == ["itm_head.bias", "itm_head.weight"]
    own = dict(dst.named_parameters())
    for key in report["missing"]:
        torch.testing.assert_close(own[key].detach(), before[key], atol=0, rtol=0)
    torch.testing.assert_close(own["text_encoder.bert.encoder.layer.1.output.dense.weight"],
                               sd["text_encoder.bert.encoder.layer.1.output.dense.weight"],
                               atol=0, rtol=0)
    torch.testing.assert_close(own["visual_encoder.model.patch_embed.kernel"],
                               src.visual_encoder.model.patch_embed.kernel, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_inference_ckpt_loads_the_ports_weights_back(retrieval_setup, tmp_path, dtype):
    """A model's weights written by ``alpro_state_dict_of`` + ``torch.save``
    (fp32, or bf16 as ``chip_smoke.py`` writes them) come back through
    ``inference_model_ckpt`` bit for bit, every key loaded."""
    from alpro_tpu_torch.checkpoint.load import alpro_state_dict_of
    from alpro_tpu_torch.cli import common

    _, cfg = retrieval_setup
    cfg = Config(dict(cfg, device="cpu"))
    src = common.build_model_from_cfg(cfg, "retrieval", seed=7)
    path = tmp_path / "w.pt"
    torch.save({k: v.to(dtype) for k, v in alpro_state_dict_of(src).items()}, path)
    dst = common.load_inference_params(common.build_model_from_cfg(cfg, "retrieval"),
                                       Config(dict(cfg, inference_model_ckpt=str(path))))
    want = dict(src.named_parameters())
    for key, got in dst.named_parameters():
        torch.testing.assert_close(got, want[key].to(dtype).float(), atol=0, rtol=0)
