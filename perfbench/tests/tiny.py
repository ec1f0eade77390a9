"""A tiny ALPRO (2 video blocks of width 64 on 2 frames of 32², 2 BERT
layers of width 64) and tiny cells, for driving the harness on the CPU."""

from __future__ import annotations

import copy
import json

import torch

from perfbench.lib.harness import ROOT, Cell
from perfbench.lib.runctx import RunCtx
from perfbench.lib.spans import Spans


def tiny_config(name: str) -> dict:
    cfg = json.loads((ROOT / "configs" / f"{name}.json").read_text())
    cfg["model_config"] = dict(cfg["model_config"], hidden_size=64, num_hidden_layers=2,
                               num_attention_heads=2, intermediate_size=128, vocab_size=400,
                               max_position_embeddings=64, fusion_layer=1)
    cfg["visual_model_cfg"] = dict(cfg["visual_model_cfg"], embed_dim=64, depth=2, num_heads=2)
    cfg.update(crop_img_size=32, num_frm=2, max_txt_len=12)
    if cfg.get("num_labels"):
        cfg.update(num_labels=16, train_batch_size=4)
    return cfg


def tiny_cell(name: str, config: str, traffic: str, limits=None, **traffic_kw) -> Cell:
    tr = json.loads((ROOT / "traffic" / f"{traffic}.json").read_text())
    tr.update(traffic_kw)
    return Cell(name=name, chips=1, config_name=config, config=tiny_config(config),
                traffic_name=traffic, traffic=tr, limits=dict(limits or {}), end_to_end=[],
                per_layer=[])


def ctx_for(cell: Cell, seed: int = 2 ** 33 + 7, seconds: float = 0.5,
            control: bool = False) -> RunCtx:
    return RunCtx(cell=copy.deepcopy(cell), seed=seed, seconds=seconds, trace=False,
                  device=torch.device("cpu"), spans=Spans(), control=control)
