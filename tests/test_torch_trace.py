"""The port's spans (``alpro_tpu_torch/core/trace.py``) on the CPU at toy
sizes: off they record nothing and never reach the profiler; on they nest
as the serving, train-step and training-loop boundaries open them, a
request's spans under its top span and a micro-step's under its rid, and
change no result; ``maybe_profile``'s Chrome trace holds them. The sharded
index's and the data-parallel step's spans: ``tests/test_torch_sharded_
serving.py``, ``tests/test_torch_dp_step.py``."""

import contextlib
import json
import threading

import numpy as np
import pytest
import torch

from alpro_tpu_torch.cli.common import run_train_loop
from alpro_tpu_torch.core import trace
from alpro_tpu_torch.core.config import Config
from alpro_tpu_torch.data.tokenization import WordPieceTokenizer, make_test_vocab
from alpro_tpu_torch.models.alpro import build_qa_model, build_retrieval_model, init_random_
from alpro_tpu_torch.models.bert import BertConfig
from alpro_tpu_torch.models.timesformer import TimeSformerConfig
from alpro_tpu_torch.serving.retrieval import RetrievalIndex
from alpro_tpu_torch.train.optimizer import build_optimizer
from alpro_tpu_torch.train.state import TrainState
from alpro_tpu_torch.train.step import make_qa_train_step

BERT = dict(vocab_size=100, hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=32, fusion_layer=1, hidden_dropout_prob=0.1)
VIS = dict(img_size=32, patch_size=16, num_frames=2, embed_dim=16, depth=2, num_heads=2,
           drop_path_rate=0.1)
TEXTS = ["a dog runs", "the cat jumps", "a person is playing"]
MODEL_SPANS = {"alpro.video", "alpro.text", "alpro.fusion"}


@pytest.fixture(autouse=True)
def spans_off():
    """Each test starts and ends with spans off and an empty store."""
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


def _clips(n, seed=0):
    return np.random.RandomState(seed).randint(0, 255, (n, 2, 32, 32, 3), np.uint8)


def _index():
    model = build_retrieval_model(BertConfig(**BERT), TimeSformerConfig(**VIS), img_size=32,
                                  num_frm=2)
    init_random_(model, torch.Generator().manual_seed(0))
    index = RetrievalIndex(model, WordPieceTokenizer(make_test_vocab()), "cpu", max_txt_len=8,
                           topk=3)
    index.add_videos(_clips(5), ids=[f"v{i}" for i in range(5)])
    return index


def _qa_state(accum: int = 2):
    model = build_qa_model(BertConfig(**BERT), TimeSformerConfig(**VIS), num_labels=5,
                           img_size=32, num_frm=2)
    init_random_(model, torch.Generator().manual_seed(1))
    opt = build_optimizer(lambda s: 1e-3, grad_norm=1.0, accum_steps=accum)
    return make_qa_train_step(model, opt), TrainState.create(model, opt)


def _qa_batch(i: int, b: int = 2) -> dict:
    rng = np.random.RandomState(10 + i)
    enc = WordPieceTokenizer(make_test_vocab())(TEXTS[:b], max_length=8)
    return {"visual_inputs": _clips(b, 20 + i),
            "text_input_ids": np.asarray(enc["input_ids"], np.int64),
            "text_input_mask": np.asarray(enc["attention_mask"], np.int64),
            "labels": rng.randint(0, 5, b).astype(np.int64)}


def _torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _children(spans, parent):
    return sorted((s for s in spans if s.parent == parent.id), key=lambda s: s.start)


def _descendants(spans, parent):
    out, frontier = [], [parent.id]
    while frontier:
        kids = [s for s in spans if s.parent in frontier]
        out += kids
        frontier = [s.id for s in kids]
    return out


def test_off_records_nothing_and_enters_no_record_function(monkeypatch):
    index = _index()
    step, state = _qa_state()

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with spans off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert trace.span("query") is trace.span("step", rid=3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        index.query(TEXTS[0])
        index.add_videos(_clips(1), ["w"])
        step(state, _torch_batch(_qa_batch(0)), 7)
    assert not [e.name for e in prof.events() if e.name.startswith("alpro.")]
    assert trace.drain() == ([], 0)


def test_query_spans_nest_in_order_under_one_rid():
    """A query's spans are the ones under its ``alpro.query`` span: the
    query span's ``id`` groups them (queries carry no rid)."""
    index = _index()
    trace.enable()
    index.query(TEXTS[0])
    index.query_batch(TEXTS[1:])
    spans, dropped = trace.drain()
    assert dropped == 0
    queries = sorted((s for s in spans if s.name == "alpro.query"), key=lambda s: s.start)
    assert [(q.rid, q.parent) for q in queries] == [(None, None), (None, None)]
    under = [{s.id for s in _descendants(spans, q)} for q in queries]
    assert not under[0] & under[1]
    assert under[0] | under[1] | {q.id for q in queries} == {s.id for s in spans}
    for q in queries:
        kids = _children(spans, q)
        assert [k.name for k in kids] == ["alpro.query.tokenize", "alpro.text", "alpro.fusion",
                                          "alpro.query.readback"]
        assert {s.rid for s in _descendants(spans, q)} == {None}
        assert all(q.start <= k.start <= k.end <= q.end for k in kids)
        assert all(a.end <= b.start for a, b in zip(kids, kids[1:]))
        assert {k.thread for k in kids} == {q.thread}


def test_ingest_spans_count_clips_and_bytes():
    """One ``add_videos`` call is one ``alpro.ingest`` span: the copy of
    its clips' bytes, then the video tower over its clips. Spans carry no
    count; a reader takes the clips a call from the call."""
    index = _index()
    trace.enable()
    index.add_videos(_clips(3, seed=4), ["a", "b", "c"])
    spans, _ = trace.drain()
    (ingest,) = [s for s in spans if s.name == "alpro.ingest"]
    assert ingest.parent is None
    assert [k.name for k in _children(spans, ingest)] == ["alpro.ingest.h2d", "alpro.video"]
    assert len(spans) == 3 and len(index) == 8


def test_train_step_phases_nest_in_each_micro_step():
    step, state = _qa_state(accum=2)
    trace.enable()
    for i in range(2):
        state, _ = step(state, _torch_batch(_qa_batch(i)), 7)
    spans, _ = trace.drain()
    steps = sorted((s for s in spans if s.name == "alpro.step"), key=lambda s: s.start)
    assert [s.rid for s in steps] == [0, 1]
    for s in steps:
        kids = _children(spans, s)
        assert [k.name for k in kids] == ["alpro.step.forward", "alpro.step.backward",
                                          "alpro.step.optimizer"]
        assert {d.name for d in _descendants(spans, kids[0])} == MODEL_SPANS
        assert not _descendants(spans, kids[1]) and not _descendants(spans, kids[2])
        assert {d.rid for d in _descendants(spans, s)} == {s.rid}


@pytest.mark.parametrize("depth", [0, 2])
def test_train_loop_records_one_data_wait_per_step(depth):
    step, state = _qa_state(accum=1)
    cfg = Config(seed=7, prefetch_depth=depth, log_interval=100, num_valid=1)
    trace.enable()
    run_train_loop(cfg, step, state, iter([_qa_batch(i) for i in range(3)]), 3)
    spans, _ = trace.drain()
    loop = sorted((s for s in spans if s.name in ("alpro.loop.data_wait", "alpro.step")),
                  key=lambda s: s.start)
    assert [s.name for s in loop] == ["alpro.loop.data_wait", "alpro.step"] * 3
    assert all(a.end <= b.start and a.thread == b.thread for a, b in zip(loop, loop[1:]))


def test_results_are_bit_equal_with_spans_on_and_off():
    index = _index()
    got = {}
    for on in (False, True):
        step, state = _qa_state()
        (trace.enable if on else trace.disable)()
        acts = [torch.profiler.ProfilerActivity.CPU]
        with torch.profiler.profile(activities=acts) if on else contextlib.nullcontext():
            scores = [index._score([t], None) for t in TEXTS]
            losses = []
            for i in range(4):
                state, metrics = step(state, _torch_batch(_qa_batch(i)), 7)
                losses.append(metrics["loss"])
        got[on] = scores, torch.stack(losses), dict(state.model.named_parameters())
    assert trace.drain()[0]
    for (p0, s0, i0), (p1, s1, i1) in zip(got[False][0], got[True][0]):
        assert np.array_equal(p0, p1) and np.array_equal(s0, s1) and np.array_equal(i0, i1)
    assert torch.equal(got[False][1], got[True][1])
    assert all(torch.equal(p, got[True][2][n]) for n, p in got[False][2].items())


def test_maybe_profile_trace_holds_the_spans(tmp_path):
    """The Chrome trace holds the spans; the store does not keep the ones
    that ``maybe_profile`` turned spans on for, and keeps those of a reader
    that had turned them on before it."""
    index = _index()
    with trace.maybe_profile(str(tmp_path), True):
        index.query(TEXTS[0])
    assert not trace._on
    assert trace.drain() == ([], 0)
    events = json.loads((tmp_path / "profile" / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"alpro.query", "alpro.query.tokenize", "alpro.text", "alpro.fusion",
            "alpro.query.readback"} <= names
    trace.enable()
    with trace.maybe_profile(str(tmp_path / "again"), True):
        index.query(TEXTS[1])
    assert trace._on
    assert [s.name for s in trace.drain()[0]].count("alpro.query") == 1


def test_store_is_capped_and_counts_drops_and_parents_stay_on_their_thread(monkeypatch):
    monkeypatch.setattr(trace, "CAP", 3)
    trace.enable()
    seen = {}

    def other():
        with trace.span("other") as s:
            seen["other"] = s

    with trace.span("outer", rid=5) as outer:
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        with trace.span("inner"):
            pass
    for _ in range(2):
        with trace.span("more"):
            pass
    spans, dropped = trace.drain()
    assert [s.name for s in spans] == ["alpro.other", "alpro.inner", "alpro.outer"]
    assert dropped == 2
    other_span, inner, outer_span = spans
    assert other_span.parent is None and other_span.rid is None
    assert other_span.thread != outer_span.thread
    assert (inner.parent, inner.rid) == (outer.id, 5)
    assert trace.drain() == ([], 0)


def _pretrain_parts():
    from alpro_tpu_torch.models.alpro import build_pretrain_model, build_prompter_model

    model = build_pretrain_model(BertConfig(**BERT), TimeSformerConfig(**VIS), num_entities=4,
                                 img_size=32, num_frm=2)
    init_random_(model, torch.Generator().manual_seed(1))
    teacher = build_prompter_model(BertConfig(**BERT), TimeSformerConfig(**VIS), img_size=32,
                                   num_frm=2)
    init_random_(teacher, torch.Generator().manual_seed(2))
    return model, teacher.eval().requires_grad_(False)


def _pretrain_batch() -> dict:
    batch = _qa_batch(0, 3)
    del batch["labels"]
    ids, rng = batch["text_input_ids"], np.random.RandomState(4)
    labels = np.full_like(ids, -100)
    labels[:, 1] = ids[:, 1]
    crop = np.zeros_like(batch["visual_inputs"])
    crop[:, :, :16, :16] = batch["visual_inputs"][:, :, :16, :16]
    mpm_mask = np.ones((3, 2, 2), np.float32)
    mpm_mask[:, 0, 0] = 0
    batch.update(mlm_text_input_ids=np.where(labels != -100, 4, ids), mlm_labels=labels,
                 crop_visual_inputs=crop, mpm_mask=mpm_mask)
    batch["visual_inputs"] = rng.randint(0, 255, batch["visual_inputs"].shape).astype(np.uint8)
    return _torch_batch(batch)


def test_pretrain_objectives_teacher_and_banks_have_their_spans():
    """A pretraining step's forward holds, in order, the towers, then
    ``alpro.pretrain.vtc``, ``.vtm`` (⊃ the 3B-row fusion), ``.mlm`` (⊃ the
    second text half and fusion) and ``.mpm`` (⊃ ``alpro.teacher`` ⊃ the
    teacher's tower); one ``alpro.prompt_bank`` a bank built; the step's
    numbers are bit-equal with spans on and off."""
    from alpro_tpu_torch.objectives.pem import build_prompt_bank
    from alpro_tpu_torch.train.step import make_pretrain_train_step

    got = {}
    for on in (False, True):
        model, teacher = _pretrain_parts()
        (trace.enable if on else trace.disable)()
        enc = WordPieceTokenizer(make_test_vocab())([f"a {w}" for w in ("dog", "cat")] * 2,
                                                    max_length=8)
        ids, mask = (torch.as_tensor(np.asarray(enc[k])) for k in ("input_ids",
                                                                    "attention_mask"))
        banks = {kind: build_prompt_bank(lambda i, m: teacher.text_feat(teacher.embed_text(i, m)),
                                         ids, mask, 2, chunk_size=3)
                 for kind in ("video", "image")}
        opt = build_optimizer(lambda s: 1e-3, grad_norm=1.0)
        step = make_pretrain_train_step(model, opt, num_local_blocks=1, teacher=teacher,
                                        banks={k: torch.cat([v, -v]) for k, v in banks.items()})
        state, metrics = step(TrainState.create(model, opt), _pretrain_batch(), 7, "image")
        got[on] = metrics, dict(state.model.named_parameters())
    spans, dropped = trace.drain()
    assert dropped == 0
    banks = [s for s in spans if s.name == "alpro.prompt_bank"]
    assert len(banks) == 2 and {s.parent for s in banks} == {None}
    assert all({d.name for d in _descendants(spans, b)} == {"alpro.text"} for b in banks)
    (step_span,) = [s for s in spans if s.name == "alpro.step"]
    (forward,) = [s for s in _children(spans, step_span) if s.name == "alpro.step.forward"]
    kids = _children(spans, forward)
    assert [k.name for k in kids] == ["alpro.video", "alpro.text", "alpro.pretrain.vtc",
                                      "alpro.pretrain.vtm", "alpro.pretrain.mlm",
                                      "alpro.pretrain.mpm"]
    assert all(a.end <= b.start for a, b in zip(kids, kids[1:]))
    under = {k.name: [c.name for c in _children(spans, k)] for k in kids}
    assert under["alpro.pretrain.vtc"] == []
    assert under["alpro.pretrain.vtm"] == ["alpro.fusion"]
    assert under["alpro.pretrain.mlm"] == ["alpro.text", "alpro.fusion"]
    assert under["alpro.pretrain.mpm"] == ["alpro.teacher"]
    (teacher_span,) = [s for s in spans if s.name == "alpro.teacher"]
    assert [c.name for c in _children(spans, teacher_span)] == ["alpro.video"]
    assert {d.rid for d in _descendants(spans, step_span)} == {0}
    assert set(got[True][0]) == {"itc_loss", "itm_loss", "mlm_loss", "mpm_loss", "mpm_kept",
                                 "loss"}
    assert all(torch.equal(v, got[True][0][k]) for k, v in got[False][0].items())
    assert all(torch.equal(p, got[True][1][n]) for n, p in got[False][1].items())
