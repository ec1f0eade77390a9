"""The port's multi-process layer: ``core/distributed.py``, ``core/mesh.py``,
``parallel/collectives.py``, ``parallel/host_sync.py`` and
``parallel/__init__.py::vtc_loss_explicit``.

In this process, without a process group: the one-process answers of
``process_info``, ``data_shards``, ``local_batch_size`` and ``make_mesh``,
and ``axis_names_for_shape`` as JAX's. Under a one-process gloo group: the
wrapped retrieval step (``shard_step``) bit-equal to the unwrapped one over
two AdamW steps with dropout and drop-path on. On two gloo processes (one
spawn of ``tests/torch_dist_worker.py``): ``all_gather_with_grad``'s values
and gradients against one process's autograd on the whole input; the
gathered VTC's shares summing to the one-process loss, their gradients the
whole batch's rows; ``vtc_loss_explicit`` against JAX's on a 2-device mesh
(within 1e-6); MLM's shares summing to the whole batch's loss with unequal
masked counts; host sync as ``tests/test_multiprocess.py`` checks it; the
mesh's axes, ``replicate``, ``shard_batch`` and the flat all-reduce.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_dist_worker as W
from alpro_tpu.core import mesh as jax_mesh
from alpro_tpu.parallel import vtc_loss_explicit as jax_vtc_explicit
from alpro_tpu_torch.core import distributed as D
from alpro_tpu_torch.core import mesh as M
from alpro_tpu_torch.objectives.mlm import mlm_loss
from alpro_tpu_torch.objectives.vtc import vtc_loss


def test_one_process_without_a_group(monkeypatch):
    for key in ("ALPRO_COORDINATOR", "ALPRO_DISTRIBUTED"):
        monkeypatch.delenv(key, raising=False)
    assert not D.maybe_initialize("cpu") and not dist.is_initialized()
    assert D.process_info() == (0, 1) and D.is_primary() and D.data_shards() == (1, 0)
    assert D.local_batch_size(3) == 3 and D.reads_rows() and D.reads_rows([1, 1])
    assert (D.backend_for("cuda:1"), D.backend_for("cpu")) == ("nccl", "gloo")
    mesh = M.make_mesh()
    assert (mesh.shape, mesh.axis_names, mesh.dp) == ((1,), ("dp",), M.MeshAxis("dp", 1, 0, None))
    assert [a.group for a in M.make_mesh([1, 1]).axes] == [None, None]
    with pytest.raises(ValueError, match="the run has 1"):
        M.make_mesh([2])
    for shape in ([4], [2, 2]):
        assert M.axis_names_for_shape(shape) == jax_mesh.axis_names_for_shape(shape)
    with pytest.raises(ValueError):
        M.axis_names_for_shape([1, 1, 1])


def test_wrapped_step_is_the_unwrapped_step_at_one_process(tmp_path):
    """W = 1 under a gloo group: the same generator draws and no extra
    rounding, so losses and every parameter are bit-equal after 2 steps."""
    from alpro_tpu_torch.models.alpro import build_retrieval_model, init_random_
    from alpro_tpu_torch.models.bert import BertConfig
    from alpro_tpu_torch.models.timesformer import TimeSformerConfig
    from alpro_tpu_torch.train.optimizer import build_optimizer, get_lr_schedule
    from alpro_tpu_torch.train.state import TrainState
    from alpro_tpu_torch.train.step import make_retrieval_train_step, shard_step

    model = build_retrieval_model(BertConfig(**W.BERT), TimeSformerConfig(
        **W.VIS, drop_rate=0.1, drop_path_rate=0.1), img_size=32, num_frm=2)
    init_random_(model, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    batch = {"visual_inputs": torch.from_numpy(rng.randint(0, 256, (4, 2, 32, 32, 3))
                                               .astype(np.uint8)),
             "text_input_ids": torch.from_numpy(rng.randint(1, 100, (4, 8))),
             "text_input_mask": torch.ones(4, 8, dtype=torch.int64)}

    def run(wrapped):
        m = copy.deepcopy(model)
        opt = build_optimizer(get_lr_schedule("linear", 1e-3, 10), grad_norm=5.0)
        state, step = TrainState.create(m, opt), make_retrieval_train_step(m, opt)
        if wrapped:
            mesh = M.make_mesh([1])
            assert mesh.dp.group is dist.group.WORLD
            step = shard_step(step, mesh)
        metrics = [step(state, batch, 7)[1] for _ in range(2)]
        return metrics, dict(m.named_parameters())

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        (m0, p0), (m1, p1) = run(False), run(True)
    finally:
        dist.destroy_process_group()
    assert all(a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
               for a, b in zip(m0, m1))
    assert all(torch.equal(p0[n], p1[n]) for n in p0)
    assert any(not torch.equal(p0[n], p) for n, p in model.named_parameters())  # it trained


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("distributed"))
    rng = np.random.RandomState(0)
    vf = rng.randn(4, 8).astype(np.float32)
    tf = rng.randn(4, 8).astype(np.float32)
    vf /= np.linalg.norm(vf, axis=1, keepdims=True)
    tf /= np.linalg.norm(tf, axis=1, keepdims=True)
    labels = np.full((4, 5), -100, np.int64)
    labels[0, 1], labels[2, 0], labels[2, 3], labels[3, 4] = 3, 1, 6, 2  # 1 and 3 masked
    inputs = {"x": rng.randn(2, 3, 4), "w": rng.randn(2, 6, 4), "vf": vf, "tf": tf,
              "temp": 0.07, "mlm_logits": rng.randn(4, 5, 7).astype(np.float32),
              "mlm_labels": labels}
    torch.save(inputs, os.path.join(workdir, "distributed_in.pt"))
    return inputs, W.spawn("distributed", 2, workdir)


def test_process_info_on_two_processes(spawned):
    _, out = spawned
    for r, o in enumerate(out):
        assert o["process_info"] == (r, 2) and o["primary"] == (r == 0)
        assert o["data_shards"] == (2, r) and o["local_batch"] == 2
        # over (1, 2) both read dp stripe 0, and only sp rank 0 loads its rows
        assert o["sp_shards"] == (1, 0) and o["sp_local_batch"] == 4
        assert o["reads_rows"] == (True, r == 0)


def test_all_gather_with_grad_matches_one_process_autograd(spawned):
    inputs, out = spawned
    xs = [torch.from_numpy(x).requires_grad_(True) for x in inputs["x"]]
    g = torch.cat(xs)
    sum((torch.from_numpy(w) * g.pow(2)).sum() for w in inputs["w"]).backward()
    for r, o in enumerate(out):
        np.testing.assert_array_equal(o["gather"], g.detach().numpy())
        np.testing.assert_allclose(o["gather_grad"], xs[r].grad.numpy(), rtol=1e-12, atol=0)


def test_gathered_vtc_shares_sum_to_the_whole_batch_loss(spawned):
    inputs, out = spawned
    vf, tf = (torch.from_numpy(inputs[k]).requires_grad_(True) for k in ("vf", "tf"))
    loss, sim_v2t, _ = vtc_loss(vf, tf, torch.tensor(inputs["temp"]))
    loss.backward()
    np.testing.assert_allclose(sum(o["vtc_share"] for o in out), float(loss.detach()), atol=1e-6,
                               rtol=0)
    for r, o in enumerate(out):
        rows = slice(2 * r, 2 * r + 2)
        np.testing.assert_allclose(o["vtc_sims"], sim_v2t[rows].detach().numpy(), atol=1e-5)
        np.testing.assert_allclose(o["vtc_grads"][0], vf.grad[rows].numpy(), atol=1e-6, rtol=0)
        np.testing.assert_allclose(o["vtc_grads"][1], tf.grad[rows].numpy(), atol=1e-6, rtol=0)


def test_vtc_loss_explicit_matches_jax(spawned):
    inputs, out = spawned
    mesh = jax_mesh.make_mesh(devices=jax.devices()[:2])
    want = float(jax_vtc_explicit(mesh, jnp.asarray(inputs["vf"]), jnp.asarray(inputs["tf"]),
                                  jnp.float32(inputs["temp"])))
    for o in out:
        np.testing.assert_allclose(o["vtc_explicit"], want, atol=1e-6, rtol=0)


def test_mlm_shares_use_the_whole_batch_count(spawned):
    inputs, out = spawned
    want = float(mlm_loss(torch.from_numpy(inputs["mlm_logits"]),
                          torch.from_numpy(inputs["mlm_labels"])))
    np.testing.assert_allclose(sum(o["mlm_share"] for o in out), want, atol=1e-6, rtol=0)
    per_rank_mean = sum(float(mlm_loss(torch.from_numpy(inputs["mlm_logits"][2 * r:2 * r + 2]),
                                       torch.from_numpy(inputs["mlm_labels"][2 * r:2 * r + 2])))
                        for r in range(2)) / 2
    assert abs(per_rank_mean - want) > 1e-3  # the counts differ: a mean of means is wrong


def test_host_sync_across_two_processes(spawned):
    _, out = spawned
    for o in out:
        assert [g["rank"] for g in o["gathered"]] == [0, 1]
        assert o["gathered"][1]["payload"] == "x" * 15
        assert o["bcast"] == {"seed": 1234}
    assert out[0]["merged"] == out[1]["merged"]
    assert sorted(m["vid_id"] for m in out[0]["merged"]) == [f"video{i}" for i in range(7)]


def test_mesh_replicate_shard_and_flat_all_reduce(spawned):
    _, out = spawned
    for r, o in enumerate(out):
        assert o["mesh"] == [("dp", 2, r, True), ("dp", 2, r, True), ("sp", 1, 0, False)]
        np.testing.assert_array_equal(o["replicated"], np.zeros((2, 3)))  # rank 0's
        np.testing.assert_array_equal(o["shard"], np.arange(8).reshape(4, 2)[2 * r:2 * r + 2])
        np.testing.assert_array_equal(o["flat"][0], [3.0, 3.0])
        np.testing.assert_array_equal(o["flat"][1], [30.0] * 3)
        assert o["flat"][2].dtype == np.int64 and list(o["flat"][2]) == [3, 3]
