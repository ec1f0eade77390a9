"""The port's entry points (counterparts of ``__graft_entry__.py``).

* ``entry()`` — the ALPRO-base retrieval forward (TimeSformer-B/16 + split
  BERT-base, bf16, seeded random weights) on the card, at the JAX entry's
  shapes (B 2, T 8, 224², 40 tokens): ``(fn, example_args)``, with
  ``fn(*example_args)`` → (sims, ITM logits).
* ``dryrun_multichip(n, device='cuda')`` — one retrieval train step over an
  n-process ``dp`` mesh at the JAX dry run's tiny widths, the
  sequence-parallel temporal attention over the same processes, with
  n >= 4 the step on an (n/2, 2) mesh, the model splitting its frames over
  ``sp`` as JAX's 2-D dry run lays them, and the attention alone over
  ``sp``, and a ``ShardedRetrievalIndex`` of n + 1 videos (a padded
  slice), top-3. ``device='cuda'`` runs one NCCL process per GPU and
  raises with fewer than n GPUs; ``device='cpu'`` runs n gloo processes.
  Neither falls back to the other.

    python -m alpro_tpu_torch.entry --dryrun N [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def entry():
    """(fn, example_args): the retrieval forward on the full-size model on
    the card; ``fn`` returns (sims (B, B), ITM logits (B, 2))."""
    from alpro_tpu_torch.models.alpro import build_retrieval_model, init_random_
    from alpro_tpu_torch.models.bert import BertConfig
    from alpro_tpu_torch.models.timesformer import TimeSformerConfig

    if not torch.cuda.is_available():
        raise RuntimeError("entry() runs on the card; torch sees no CUDA device")
    B, T, S, L = 2, 8, 224, 40
    vis = TimeSformerConfig(img_size=S, patch_size=16, num_frames=T, embed_dim=768, depth=12,
                            num_heads=12, drop_path_rate=0.1)
    with torch.device("meta"):
        model = build_retrieval_model(BertConfig(), vis, img_size=S, num_frm=T,
                                      dtype=torch.bfloat16)
    model = model.to_empty(device="cuda")
    init_random_(model, torch.Generator(device="cuda").manual_seed(0))
    model.eval()
    rng = np.random.RandomState(0)
    pixels = torch.from_numpy(rng.rand(B, T, S, S, 3).astype(np.float32)).cuda()
    ids = torch.from_numpy(rng.randint(0, 30522, (B, L))).cuda()
    mask = torch.ones(B, L, dtype=torch.int64, device="cuda")

    @torch.inference_mode()
    def fn(pixels, ids, mask):
        out = model(pixels, ids, mask)
        return out["sim"], out["itm_logits"]

    return fn, (pixels, ids, mask)


# ---- the multi-process dry run ----
_VIS = dict(img_size=32, patch_size=16, num_frames=2, embed_dim=32, depth=2, num_heads=4,
            drop_path_rate=0.1)
_BERT = dict(vocab_size=512, hidden_size=32, num_hidden_layers=4, num_attention_heads=4,
             intermediate_size=64, fusion_layer=2)


def _tiny_model(device, sp_axis=None):
    from alpro_tpu_torch.models.alpro import build_retrieval_model, init_random_
    from alpro_tpu_torch.models.bert import BertConfig
    from alpro_tpu_torch.models.timesformer import TimeSformerConfig

    model = build_retrieval_model(BertConfig(**_BERT), TimeSformerConfig(**_VIS, sp_axis=sp_axis),
                                  img_size=32, num_frm=2).to(device)
    return init_random_(model, torch.Generator(device=device).manual_seed(0))


def _train_step_on(mesh, batch, device, blocks: int) -> float:
    """One retrieval train step over ``mesh`` from rank 0's state (a 2-D
    mesh's model splits its frames over ``sp``); returns the loss, checked
    finite and equal on every process."""
    from alpro_tpu_torch.core.mesh import SEQ_AXIS, replicate, shard_batch
    from alpro_tpu_torch.parallel.host_sync import all_gather_list
    from alpro_tpu_torch.train.optimizer import build_optimizer, get_lr_schedule
    from alpro_tpu_torch.train.state import TrainState
    from alpro_tpu_torch.train.step import make_retrieval_train_step, shard_step

    model = _tiny_model(device, SEQ_AXIS if mesh.sp_size > 1 else None)
    opt = build_optimizer(get_lr_schedule("linear", 1e-4, 100), grad_norm=5.0)
    state = TrainState.create(model, opt)
    replicate(model, state.opt_state)
    step = shard_step(make_retrieval_train_step(model, opt, num_local_blocks=blocks), mesh)
    state, metrics = step(state, shard_batch(mesh, batch, device), 0)
    loss = float(metrics["loss"])
    checksum = float(sum(p.double().sum() for p in model.parameters()))
    seen = all_gather_list((loss, checksum))
    if not np.isfinite(loss) or state.step != 1:
        raise RuntimeError(f"dry-run step: loss {loss}, step {state.step}")
    if len(set(seen)) != 1:
        raise RuntimeError(f"dry-run step: processes disagree on (loss, parameters): {seen}")
    return loss


def _sp_attention(group, n_sp: int, device, rng) -> float:
    """The sequence-parallel temporal attention over ``group`` (T = 2 · n_sp
    frames) against the unsplit attention; returns the largest gap."""
    from alpro_tpu_torch.ops.attention import multi_head_attention
    from alpro_tpu_torch.parallel.collectives import group_rank
    from alpro_tpu_torch.parallel.seq_parallel import sharded_temporal_attention

    D, H, T = 32, 4, 2 * n_sp
    x = torch.from_numpy(rng.randn(4, T, D).astype(np.float32)).to(device)
    qkv_w = torch.from_numpy(rng.randn(3 * D, D).astype(np.float32) * 0.05).to(device)
    proj_w = torch.from_numpy(rng.randn(D, D).astype(np.float32) * 0.05).to(device)
    qkv_b, proj_b = torch.zeros(3 * D, device=device), torch.zeros(D, device=device)
    r, t = group_rank(group), T // n_sp
    got = sharded_temporal_attention(x[:, r * t:(r + 1) * t], qkv_w, qkv_b, proj_w, proj_b, H,
                                     group)
    q, k, v = (torch.nn.functional.linear(x, qkv_w, qkv_b).reshape(4, T, 3, H, D // H)[:, :, i]
               .transpose(1, 2) for i in range(3))
    ref = multi_head_attention(q, k, v, impl="xla").transpose(1, 2).reshape(4, T, D)
    ref = torch.nn.functional.linear(ref, proj_w, proj_b)[:, r * t:(r + 1) * t]
    gap = float((got - ref).abs().max())
    if not torch.isfinite(got).all() or gap > 1e-4:
        raise RuntimeError(f"sequence-parallel attention misses the unsplit one by {gap}")
    return gap


def _worker(rank: int, n: int, device_kind: str, init: str, out: str) -> None:
    import torch.distributed as dist

    from alpro_tpu_torch.core.distributed import backend_for
    from alpro_tpu_torch.core.mesh import SEQ_AXIS, make_mesh
    from alpro_tpu_torch.data.tokenization import WordPieceTokenizer, make_test_vocab
    from alpro_tpu_torch.serving.sharded import ShardedRetrievalIndex

    device = torch.device(f"cuda:{rank}" if device_kind == "cuda" else "cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend_for(device), init_method=init, world_size=n, rank=rank)
    try:
        rng = np.random.RandomState(0)
        B = 2 * n
        batch = {"visual_inputs": rng.rand(B, 2, 32, 32, 3).astype(np.float32),
                 "text_input_ids": rng.randint(0, 512, (B, 8)),
                 "text_input_mask": np.ones((B, 8), np.int64)}
        report = {"loss": _train_step_on(make_mesh([n]), batch, device, n)}
        report["sp_gap"] = _sp_attention(dist.group.WORLD, n, device, np.random.RandomState(1))
        if n >= 4 and n % 2 == 0:
            mesh2d = make_mesh([n // 2, 2])
            report["loss_2d"] = _train_step_on(mesh2d, batch, device, n // 2)
            report["sp_gap_2d"] = _sp_attention(mesh2d[SEQ_AXIS].group, 2, device,
                                                np.random.RandomState(2))
        index = ShardedRetrievalIndex(_tiny_model(device).eval(),
                                      WordPieceTokenizer(make_test_vocab()), device,
                                      make_mesh([n]), max_txt_len=8, topk=3)
        index.add_videos(rng.randint(0, 255, (n + 1, 2, 32, 32, 3)).astype(np.uint8),
                         ids=[f"v{i}" for i in range(n + 1)])
        hits = index.query("a test video")
        if len(hits) != min(3, n + 1) or not all(np.isfinite(h[1]) for h in hits):
            raise RuntimeError(f"sharded index: {hits}")
        report["hits"] = hits
        with open(out, "w") as f:
            json.dump(report, f)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n: int, device: str = "cuda", timeout_s: int = 600) -> dict:
    """Run the dry run on n processes; returns rank 0's report ({loss,
    sp_gap, [loss_2d, sp_gap_2d,] hits}). Raises if any process fails or the
    processes disagree."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(f"dryrun_multichip({n}, 'cuda') needs {n} GPUs, one per "
                               f"process; torch sees {have}")
    env = {k: v for k, v in os.environ.items()
           if k not in ("ALPRO_COORDINATOR", "ALPRO_DISTRIBUTED", "RANK", "WORLD_SIZE",
                        "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory() as td:
        init = "file://" + os.path.join(td, "rendezvous")
        outs = [os.path.join(td, f"rank{r}.json") for r in range(n)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "alpro_tpu_torch.entry", "--worker", str(r), str(n), device,
             init, outs[r]], env=env, cwd=_REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT) for r in range(n)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout_s)[0].decode(errors="replace"))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, p in enumerate(procs):
            if p.returncode != 0:
                raise RuntimeError(f"dry-run process {r} failed (rc {p.returncode}):\n"
                                   + logs[r][-3000:])
        reports = []
        for o in outs:
            with open(o) as f:
                reports.append(json.load(f))
    if any(r["hits"] != reports[0]["hits"] for r in reports):
        raise RuntimeError(f"sharded index: processes disagree: {reports}")
    return reports[0]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dryrun", type=int, default=None, help="processes of the dry run")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--worker", nargs=5, default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        rank, n, device, init, out = args.worker
        _worker(int(rank), int(n), device, init, out)
        return
    if args.dryrun is None:
        p.error("nothing to run: pass --dryrun N")
    report = dryrun_multichip(args.dryrun, args.device)
    print(f"dryrun_multichip({args.dryrun}, {args.device!r}): {json.dumps(report)}")


if __name__ == "__main__":
    main()
