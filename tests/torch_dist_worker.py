"""Worker processes of the port's multi-process CPU tests
(``tests/test_torch_{distributed,dp_step,dp_step_tasks,sharded_serving,
seq_parallel,sp_step}.py``).

``spawn(job, world, workdir)`` starts ``world`` processes of this file, each
joining one gloo process group on a ``FileStore`` in ``workdir``; each runs
``JOBS[job](rank, world, workdir)`` on the inputs the test wrote to
``workdir/<job>_in.pt`` and saves what it returns to
``workdir/<job>_<rank>.pt``. The workers import torch and the port only;
the test process runs the JAX package and compares. One spawn serves every
check of a test file.

    python tests/torch_dist_worker.py JOB RANK WORLD WORKDIR
"""

import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# the toy ALPRO of tests/test_torch_train_step.py
BERT = dict(vocab_size=100, hidden_size=32, num_hidden_layers=4, num_attention_heads=2,
            intermediate_size=64, fusion_layer=2)
VIS = dict(img_size=32, patch_size=16, num_frames=2, embed_dim=32, depth=2, num_heads=2)
NO_DROP_BERT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
NO_DROP_VIS = dict(drop_rate=0.0, drop_path_rate=0.0)
NUM_ENTITIES, NUM_LABELS = 5, 5


def build(kind: str, attn_impl: str = "xla"):
    """The toy ``kind`` model ('retrieval', 'qa', 'pretrain', 'prompter') of
    the port, dropout and drop-path 0, fp32."""
    from alpro_tpu_torch.models import alpro
    from alpro_tpu_torch.models.bert import BertConfig
    from alpro_tpu_torch.models.timesformer import TimeSformerConfig

    bert = BertConfig(**BERT, **NO_DROP_BERT, attn_impl=attn_impl)
    vis = TimeSformerConfig(**VIS, **NO_DROP_VIS, attn_impl=attn_impl)
    kw = dict(img_size=32, num_frm=2)
    if kind == "qa":
        return alpro.build_qa_model(bert, vis, num_labels=NUM_LABELS, **kw)
    if kind == "pretrain":
        return alpro.build_pretrain_model(bert, vis, num_entities=NUM_ENTITIES, **kw)
    return getattr(alpro, f"build_{kind}_model")(bert, vis, **kw)


class GradTap:
    """The port's optimizer interface: keeps each step's gradients by
    parameter name and moves nothing."""

    def init(self, named_params):
        self.names = list(named_params)

    def update(self, state, params, grads):
        self.grads = {n: g.detach().clone() for n, g in zip(self.names, grads)}
        return True


def spawn(job: str, world: int, workdir: str, timeout: int = 300) -> list:
    """Run ``job`` on ``world`` gloo processes; returns each rank's output."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    for key in ("ALPRO_COORDINATOR", "ALPRO_DISTRIBUTED", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env.pop(key, None)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), job, str(r),
                               str(world), workdir], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} of {job} failed:\n{logs[r][-4000:]}"
    return [torch.load(os.path.join(workdir, f"{job}_{r}.pt"), weights_only=False)
            for r in range(world)]


def rows_of(batch: dict, rank: int, world: int) -> dict:
    """This rank's rows of a global numpy batch, as tensors."""
    out = {}
    for k, v in batch.items():
        b = v.shape[0] // world
        out[k] = torch.from_numpy(np.ascontiguousarray(v[rank * b:(rank + 1) * b]))
    return out


# ---- jobs ----
def job_steps(rank, world, inputs):
    """Each case's wrapped step on this rank's rows, with the program's
    spans on → (metrics, gradients, the hard negatives drawn for this
    rank's rows, the step's spans)."""
    from alpro_tpu_torch.core import trace
    from alpro_tpu_torch.core.mesh import make_mesh
    from alpro_tpu_torch.train import step as port_step
    from alpro_tpu_torch.train.state import TrainState

    mesh = make_mesh([world])
    drawn = []
    sample = port_step.sample_hard_negatives

    def record(*args, **kw):
        drawn.append(sample(*args, **kw))
        return drawn[-1]

    port_step.sample_hard_negatives = record
    out = {}
    for name, case in inputs.items():
        model = build(case["kind"])
        model.load_state_dict(case["state"])
        tap = GradTap()
        kw = dict(case.get("kw", {}))
        if "teacher" in case:
            teacher = build("prompter")
            teacher.load_state_dict(case["teacher"])
            teacher.eval().requires_grad_(False)
            bank = torch.from_numpy(case["bank"])
            kw.update(teacher=teacher, banks={"video": bank, "image": -bank})
        make = getattr(port_step, f"make_{case['make']}_train_step")
        step = port_step.shard_step(make(model, tap, **kw), mesh)
        drawn.clear()
        trace.enable()
        try:
            _, metrics = step(TrainState.create(model, tap), rows_of(case["batch"], rank, world),
                              0, *case.get("extras", ()))
        finally:
            trace.disable()
        out[name] = {"metrics": {k: float(v) for k, v in metrics.items()},
                     "grads": {k: g.numpy() for k, g in tap.grads.items()},
                     "negatives": [tuple(t.numpy() for t in d) for d in drawn],
                     "spans": _drained(trace)}
    return out


def _drained(trace) -> list:
    """The spans kept since the last drain, as dicts (none dropped)."""
    spans, dropped = trace.drain()
    assert dropped == 0
    return [s._asdict() for s in spans]


def job_distributed(rank, world, inputs):
    """The collectives, host sync, the mesh and the count reductions."""
    import torch.distributed as dist

    from alpro_tpu_torch.core import distributed as D
    from alpro_tpu_torch.core.mesh import make_mesh, replicate, shard_batch
    from alpro_tpu_torch.objectives.mlm import mlm_loss
    from alpro_tpu_torch.objectives.vtc import vtc_loss
    from alpro_tpu_torch.parallel import vtc_loss_explicit
    from alpro_tpu_torch.parallel.collectives import all_gather_with_grad, flat_all_reduce_
    from alpro_tpu_torch.parallel.host_sync import all_gather_list, barrier, broadcast_object

    out = {"process_info": D.process_info(), "primary": D.is_primary(),
           "data_shards": D.data_shards(), "local_batch": D.local_batch_size(4),
           "sp_shards": D.data_shards([1, 2]), "sp_local_batch": D.local_batch_size(4, [1, 2]),
           "reads_rows": (D.reads_rows(), D.reads_rows([1, 2]))}
    group = dist.group.WORLD
    # all_gather_with_grad: every rank's loss reads every rank's rows
    x = torch.from_numpy(inputs["x"][rank]).requires_grad_(True)
    g = all_gather_with_grad(x, group)
    loss = (torch.from_numpy(inputs["w"][rank]) * g.pow(2)).sum()
    loss.backward()
    out["gather"] = g.detach().numpy()
    out["gather_grad"] = x.grad.numpy()
    # the reference-shaped VTC and the gathered one
    vf, tf = rows_of({"vf": inputs["vf"], "tf": inputs["tf"]}, rank, world).values()
    temp = torch.tensor(inputs["temp"])
    out["vtc_explicit"] = float(vtc_loss_explicit(vf, tf, temp, group))
    vf.requires_grad_(True)
    tf.requires_grad_(True)
    share, sim_v2t, _ = vtc_loss(vf, tf, temp, group=group)
    share.backward()
    out.update(vtc_share=float(share), vtc_sims=sim_v2t.detach().numpy(),
               vtc_grads=(vf.grad.numpy(), tf.grad.numpy()))
    # MLM over the masked tokens of the whole batch
    logits, labels = rows_of({"l": inputs["mlm_logits"], "y": inputs["mlm_labels"]}, rank,
                             world).values()
    out["mlm_share"] = float(mlm_loss(logits, labels, group=group))
    # host sync (tests/test_multiprocess.py's checks)
    out["gathered"] = all_gather_list({"rank": rank, "payload": "x" * (10 + rank * 5)})
    out["bcast"] = broadcast_object({"seed": 1234} if rank == 0 else None, root=0)
    vids = [f"video{i}" for i in range(7)]
    barrier("pre-merge")
    out["merged"] = [r for shard in all_gather_list(
        [{"vid_id": v, "score": float(len(v) + rank)} for v in vids[rank::world]]) for r in shard]
    barrier("post-merge")
    # the mesh: 1-D and (dp, 1); replicate; shard_batch; the flat all-reduce
    mesh, mesh2 = make_mesh(), make_mesh([world, 1])
    out["mesh"] = [(a.name, a.size, a.rank, a.group is not None)
                   for m in (mesh, mesh2) for a in m.axes]
    model = torch.nn.Linear(3, 2)
    torch.nn.init.constant_(model.weight, float(rank))
    replicate(model)
    out["replicated"] = model.weight.detach().numpy()
    out["shard"] = shard_batch(mesh, {"a": np.arange(8).reshape(4, 2)})["a"].numpy()
    ts = [torch.full((2,), float(rank + 1)), torch.full((3,), 10.0 * (rank + 1)),
          torch.full((2,), rank + 1, dtype=torch.int64)]
    flat_all_reduce_(ts, mesh.dp.group)
    out["flat"] = [t.numpy() for t in ts]
    return out


def job_index(rank, world, inputs):
    """``ShardedRetrievalIndex`` (bf16 weights as stored, and int8) on this
    rank's slice of the gallery, the bf16 one with the program's spans on;
    ``save`` of the whole gallery, and its ``load`` into another sharded
    index."""
    from alpro_tpu_torch.core import trace
    from alpro_tpu_torch.core.mesh import make_mesh
    from alpro_tpu_torch.data.tokenization import WordPieceTokenizer, make_test_vocab
    from alpro_tpu_torch.serving import sharded
    from alpro_tpu_torch.serving.sharded import ShardedRetrievalIndex

    model = build("retrieval")
    model.load_state_dict(inputs["state"])
    model.eval()
    tok = WordPieceTokenizer(make_test_vocab())
    out = {}
    for weights in ("bf16", "int8"):
        index = ShardedRetrievalIndex(model, tok, "cpu", make_mesh([world]), max_txt_len=8,
                                      topk=3, weights=weights)
        if weights == "bf16":
            trace.enable()
        try:
            for lo, hi in inputs["calls"]:
                index.add_videos(inputs["clips"][lo:hi], inputs["ids"][lo:hi])
            out[weights] = {"query": [index.query(t) for t in inputs["texts"]],
                            "batch": index.query_batch(inputs["texts"]),
                            "rows": int(index._banks()[0].shape[0])}
        finally:
            trace.disable()
        if weights == "bf16":
            out["spans"] = _drained(trace)
            sharded.SAVE_BLOCK = 2  # each process's 3 rows in 2 blocks
            index.save(os.path.join(inputs["dir"], "bank"))
            loaded = ShardedRetrievalIndex(model, tok, "cpu", make_mesh([world]), max_txt_len=8,
                                           topk=3)
            loaded.load(os.path.join(inputs["dir"], "bank"))
            out["loaded"] = [loaded.query(t) for t in inputs["texts"]]
            out["loaded_gidx"] = loaded._banks()[2].tolist()
    return out


def job_seq(rank, world, inputs):
    """``sharded_temporal_attention`` on this rank's frames, with the
    gradients of sum(out · c) over the local input and the weights."""
    import torch.distributed as dist

    from alpro_tpu_torch.parallel.seq_parallel import sharded_temporal_attention

    t = inputs["x"].shape[1] // world
    x = torch.from_numpy(np.ascontiguousarray(inputs["x"][:, rank * t:(rank + 1) * t]))
    ws = [torch.from_numpy(inputs[k]).requires_grad_(True)
          for k in ("qkv_w", "qkv_b", "proj_w", "proj_b")]
    x.requires_grad_(True)
    y = sharded_temporal_attention(x, *ws, inputs["heads"], dist.group.WORLD)
    c = torch.from_numpy(np.ascontiguousarray(inputs["c"][:, rank * t:(rank + 1) * t]))
    (y * c).sum().backward()
    return {"out": y.detach().numpy(), "x_grad": x.grad.numpy(),
            "w_grads": [w.grad.numpy() for w in ws]}


class _BackwardOnAThread:
    """Within the block, ``Tensor.backward`` runs on a new thread, which
    starts with an empty ``contextvars`` context, as the autograd engine's
    device thread does for a CUDA graph (the CPU's engine runs the backward
    on the calling thread)."""

    def __enter__(self):
        import threading

        self.backward = torch.Tensor.backward
        backward = self.backward

        def on_a_thread(tensor, *args, **kw):
            failed = []

            def run():
                try:
                    backward(tensor, *args, **kw)
                except BaseException as e:  # raised again on the caller's thread
                    failed.append(e)

            t = threading.Thread(target=run)
            t.start()
            t.join()
            if failed:
                raise failed[0]

        torch.Tensor.backward = on_a_thread
        return self

    def __exit__(self, *exc):
        torch.Tensor.backward = self.backward


def job_sp_steps(rank, world, inputs):
    """Each case's retrieval step over the mesh ``inputs['mesh']`` with
    AdamW → (metrics, parameters after the step, AdamW's first moment, the
    global gradient norm before clipping, the calls of the model's split
    temporal attention). A case with ``backward_thread`` runs its backward
    pass on another thread (``_BackwardOnAThread``)."""
    import contextlib

    from alpro_tpu_torch.core.mesh import SEQ_AXIS, make_mesh, shard_batch
    from alpro_tpu_torch.models import alpro, timesformer
    from alpro_tpu_torch.models.bert import BertConfig
    from alpro_tpu_torch.models.timesformer import TimeSformerConfig
    from alpro_tpu_torch.train import step as port_step
    from alpro_tpu_torch.train.optimizer import build_optimizer, get_lr_schedule
    from alpro_tpu_torch.train.state import TrainState

    mesh = make_mesh(inputs["mesh"])
    calls = [0]
    split = timesformer.sharded_temporal_attention

    def counted(*args, **kw):
        calls[0] += 1
        return split(*args, **kw)

    timesformer.sharded_temporal_attention = counted
    out = {}
    for name, case in inputs["cases"].items():
        vis = TimeSformerConfig(**case["vis"])
        model = alpro.build_retrieval_model(BertConfig(**case["bert"]), vis,
                                            img_size=vis.img_size, num_frm=vis.num_frames)
        model.load_state_dict(case["state"])
        opt = build_optimizer(get_lr_schedule("constant", case["lr"], 100), grad_norm=5.0)
        state = TrainState.create(model, opt)
        norms = []
        update = opt.update

        def recorded(opt_state, params, grads, update=update, norms=norms):
            norms.append(float(torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g.double()) for g in grads]))))
            return update(opt_state, params, grads)

        opt.update = recorded
        step = port_step.shard_step(port_step.make_retrieval_train_step(model, opt), mesh)
        calls[0] = 0
        # an sp rank > 0 feeds nothing: its step takes sp rank 0's batch
        batch = (shard_batch(mesh, {k: torch.from_numpy(v) for k, v in case["batch"].items()})
                 if mesh[SEQ_AXIS].rank == 0 else {})
        with _BackwardOnAThread() if case.get("backward_thread") else contextlib.nullcontext():
            _, metrics = step(state, batch, case.get("seed", 0))
        names = [k for k, _ in model.named_parameters()]
        out[name] = {"metrics": {k: float(v) for k, v in metrics.items()},
                     "params": {k: p.detach().numpy().copy()
                                for k, p in model.named_parameters()},
                     "mu": {k: m.numpy().copy() for k, m in zip(names, state.opt_state.mu)},
                     "grad_norm": norms[0], "split_calls": calls[0]}
    # the step's extras come from sp rank 0 too, beside its batch
    seen = []
    lin = torch.nn.Linear(2, 1)

    def probe(batch, ctx, tag):
        seen.append((tag, batch["x"].tolist()))
        loss = lin(batch["x"]).sum()
        return loss, {"loss": loss.detach()}

    opt = build_optimizer(get_lr_schedule("constant", 0.0, 100))
    x = {"x": torch.full((1, 2), float(rank))} if mesh[SEQ_AXIS].rank == 0 else {}
    port_step.shard_step(port_step.TrainStep(lin, opt, probe), mesh)(
        TrainState.create(lin, opt), x, 0, f"from rank {rank}")
    out["extras_seen"] = seen
    return out


JOBS = {"steps": job_steps, "distributed": job_distributed, "index": job_index,
        "seq": job_seq, "sp_steps": job_sp_steps}


def main(argv) -> None:
    import torch.distributed as dist

    job, rank, world, workdir = argv[0], int(argv[1]), int(argv[2]), argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(workdir, f"{job}.store"),
                                                         world), rank=rank, world_size=world)
    try:
        inputs = torch.load(os.path.join(workdir, f"{job}_in.pt"), weights_only=False)
        out = JOBS[job](rank, world, inputs)
        torch.save(out, os.path.join(workdir, f"{job}_{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
