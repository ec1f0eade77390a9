"""TimeSformer video encoder: divided space-time attention, and the joint
and space-only attention types.

Counterpart of ``alpro_tpu/models/timesformer.py``, with its layouts:
channels-last video (B, T, H, W, 3), tokens as (B, T, N, D) with the CLS
carried as (B, 1, D), packed ``[q|k|v]`` channels. Parameter names follow the
ALPRO state dict (``checkpoint/load.py``), except the patch embedding, held
as the (p·p·C, D) matmul kernel.

The module is built in eval mode (the JAX modules' ``deterministic=True``
default); ``train()`` is the JAX ``deterministic=False``: dropout
(``drop_rate``, ``attn_drop_rate``) and drop-path (rates linspace(0,
``drop_path_rate``, depth); masks (B, 1, N, 1) on the temporal branch,
(B, T, 1, 1) on the spatial branch, one per sample on the MLP tail) drawn
from the ``generator`` passed to ``forward``, and per-block gradient
checkpointing when ``gradient_checkpointing`` is set (divided blocks only:
the joint and space-only types train without it, as in JAX).

``attention_type`` (JAX ``TimeSformerConfig.attention_type``):
``divided_space_time`` runs the ``DividedSTBlock`` below;
``joint_space_time`` runs ``JointBlock``, a pre-norm ViT block, over [cls;
all T·N patches] (K1 at S = 1 + T·N in eval where it fits);
``space_only`` runs ``JointBlock`` per frame over [cls; N] (B·T rows), adds
no ``time_embed``, and ends with the mean over frames of every token, CLS
included, so T becomes 1. ``forward``'s ``pooling`` ('temporal', 'spatial',
'none') shapes the output as JAX's does.

Per block, the three ``*_impl`` fields pick the kernel or the plain path,
by the JAX package's rules in both modes:

* ``temporal_attn_impl``: ``fused_qkv_fold`` — in eval LN, qkv matmul, the
  temporal kernel (``ops/qkv_attn.py``), then proj·temporal_fc folded into
  one matmul ``w_eff``/``b_eff`` computed in the compute dtype;
  ``fused_ln_qkv`` — the same with LN and the qkv matmul in one kernel
  (``ops/ln_matmul.py``); ``fused_block`` — LN, qkv, the attention, the
  folded projection and the residual in one kernel
  (``ops/fused_block.py``); ``fused_qkv`` — in eval LN, qkv matmul, the
  temporal kernel, then proj and temporal_fc unfolded; ``fused_qkv_proj``
  — in eval LN, qkv matmul, then the attention and the folded projection
  in one kernel (``ops/qkv_attn.py``), the residual added after. In
  training all five are the temporal kernel with its backward between the
  unfolded projections; ``packed`` and ``circulant`` — LN, qkv matmul,
  the plain-torch packed or circulant temporal attention
  (``ops/temporal_attn.py``, no kernel), proj and temporal_fc, in both
  modes; ``plain`` — relayout to (B·N, T, D), plain attention, proj,
  temporal_fc;
* ``attn_impl``: ``fused_qkv`` — the spatial kernel over the packed qkv of
  [cls_rep; x] per frame, in both modes (with its backward in training;
  attention dropout in training takes the plain path, as in JAX);
  ``fused_ln_qkv`` — in eval the LN→qkv kernel, the spatial kernel, then
  proj; ``fused_block`` — in eval LN, qkv, attention and proj in one kernel;
  ``fused_qkv_proj`` — in eval LN, the qkv matmul, then the attention and
  proj in one kernel (``ops/qkv_attn.py``); in training these three are
  ``fused_qkv``; ``cls_sideband`` — in eval LN of the patches and of the
  CLS separately, the CLS qkv once per sample, the sideband kernel
  (``ops/qkv_attn.py``: no [cls; x] concat), proj per frame for the
  patches and once on the fp32 frame mean of the CLS outputs, then
  straight to the MLP tail; in training ``auto`` (plain), as in JAX;
  ``pallas`` — the masked-attention kernel (``ops/masked_attn.py``) on
  views of the packed qkv, in both modes; ``plain`` — plain attention;
* ``mlp_impl``: ``fused`` — in eval the LN→MLP→residual kernel
  (``ops/ln_mlp.py``), called on the patch rows and on the B cls rows; in
  training the plain path; ``plain`` — LN, fc1, exact GELU, fc2, residual.

``auto`` resolves to a kernel (``fused_qkv`` for the spatial attention,
``fused_qkv_fold`` for the temporal, ``fused`` for the MLP tail) only in
eval, only for a CUDA tensor and only where that kernel takes the call
site's shape and dtype (``TimeSformerConfig.kernel_fits``: the kernel's own
limit predicate in ``ops/``), else ``plain``; ``xla`` (a JAX config's name
for the plain path) means ``plain``. The TPU package's measured gates
(``_on_tpu()``, temporal only at T <= 8, S <= 640, D % 128) are not carried
over: they are to be re-decided on the H100.

``fused_patchify='on'`` sends raw uint8 frames (B, T, H, W, 3) through the
normalize → patchify → embed kernel (``ops/preprocess.py``) in both modes;
``auto`` and ``off`` keep the unfused path, as in JAX. Pre-patchified input
never takes it.

``sp_axis`` (``--mesh_shape DP SP`` with SP > 1 sets 'sp') splits the frames
of the plain temporal branch (``plain``, and ``auto`` in training) over that
mesh axis, where a ``core/mesh.py::use_mesh`` block makes it active (a train
step under ``shard_step``; the tower reads it once, before its blocks, and
hands it to each, so a checkpointed block's recompute in the backward pass
splits as its forward did): each process attends its T/SP frames' queries
over all T and the output's frames are gathered back before the projection
dropout, the drop-path and ``temporal_fc``. Every kernel value and the
``packed`` and ``circulant`` forms stay unsplit, as JAX's constraint sits on
its XLA branch alone; outside such a block the model runs unsplit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from alpro_tpu_torch.core.mesh import MeshAxis, active_axis
from alpro_tpu_torch.models.remat import (
    TS_SPATIAL_ATTN,
    TS_TEMPORAL_ATTN,
    checkpoint_name,
    resolve_remat_policy,
)
from alpro_tpu_torch.ops.attention import multi_head_attention_bshd
from alpro_tpu_torch.ops.layers import (
    LayerNorm,
    checkpoint,
    drop_path,
    dropout,
    gelu_exact,
    linear,
)
from alpro_tpu_torch.ops import _build
from alpro_tpu_torch.ops.fused_block import fused_spatial_block, fused_temporal_block
from alpro_tpu_torch.ops.ln_matmul import ln_matmul
from alpro_tpu_torch.ops.ln_mlp import ln_mlp, ln_mlp_fits
from alpro_tpu_torch.ops.preprocess import _normalize, patchify_embed
from alpro_tpu_torch.ops.qkv_attn import (
    spatial_attention_qkv,
    spatial_attention_qkv_cls,
    spatial_attention_qkv_proj,
    spatial_fits,
    temporal_attention_qkv,
    temporal_attention_qkv_proj,
    temporal_fits,
)
from alpro_tpu_torch.ops.temporal_attn import temporal_attention_circulant, temporal_attention_packed
from alpro_tpu_torch.parallel.seq_parallel import gather_frames, sharded_temporal_attention

# field → the values naming a kernel (the first is what 'auto' gives in eval)
_KERNEL_IMPL = {
    "attn_impl": ("fused_qkv", "pallas", "fused_ln_qkv", "fused_block", "fused_qkv_proj",
                  "cls_sideband"),
    "temporal_attn_impl": ("fused_qkv_fold", "fused_qkv", "fused_ln_qkv", "fused_block",
                           "fused_qkv_proj"),
    "mlp_impl": ("fused",),
}
# field → plain-torch forms other than 'plain' (no kernel; 'auto' never picks them)
_PLAIN_FORMS = {"temporal_attn_impl": ("packed", "circulant")}
ATTENTION_TYPES = ("divided_space_time", "joint_space_time", "space_only")
POOLINGS = ("temporal", "spatial", "none")
_TEMPORAL_FORMS = {"fused_qkv": temporal_attention_qkv, "packed": temporal_attention_packed,
                   "circulant": temporal_attention_circulant}


@dataclasses.dataclass(frozen=True)
class TimeSformerConfig:
    img_size: int = 224
    patch_size: int = 16
    num_frames: int = 8
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.1
    ln_eps: float = 1e-6
    attn_impl: str = "auto"
    temporal_attn_impl: str = "auto"
    mlp_impl: str = "auto"
    # uint8 inputs are normalized with these stats (CLIP defaults)
    pixel_mean: tuple = (0.48145466, 0.4578275, 0.40821073)
    pixel_std: tuple = (0.26862954, 0.26130258, 0.27577711)
    # fold the uint8 /255-mean/std normalize into the patch-embed matmul:
    # 'auto' → on for bf16 compute, off for fp32 | 'on' | 'off'
    fold_uint8_norm: str = "auto"
    # raw uint8 frames through the normalize → patchify → embed kernel:
    # 'on'; 'auto' | 'off' → the unfused path
    fused_patchify: str = "auto"
    # per-block torch.utils.checkpoint in training (the reference's
    # per-block CheckpointFunction), keeping what remat_policy keeps
    # (models/remat.py: any of REMAT_POLICIES)
    gradient_checkpointing: bool = False
    remat_policy: str = "nothing"
    # 'divided_space_time' (DividedSTBlock), 'joint_space_time' (one
    # JointBlock attention over [cls; T·N]) or 'space_only' (JointBlock per
    # frame over [cls; N], then the mean over frames)
    attention_type: str = "divided_space_time"
    # the mesh axis the divided blocks' plain temporal attention splits its
    # frames over inside a train step run under a mesh with that axis
    # (``--mesh_shape DP SP``, SP > 1: 'sp'); unsplit everywhere else
    sp_axis: Optional[str] = None

    def __post_init__(self):
        resolve_remat_policy(self.remat_policy)
        if self.attention_type not in ATTENTION_TYPES:
            raise ValueError(f"attention_type={self.attention_type!r}: expected one of "
                             + ", ".join(map(repr, ATTENTION_TYPES)))
        for field, kernels in _KERNEL_IMPL.items():
            value = getattr(self, field)
            allowed = ("auto", "plain", "xla", *kernels, *_PLAIN_FORMS.get(field, ()))
            if value not in allowed:
                raise ValueError(
                    f"{field}={value!r}: expected one of " + ", ".join(map(repr, allowed)))
        for field in ("fold_uint8_norm", "fused_patchify"):
            if getattr(self, field) not in ("auto", "on", "off"):
                raise ValueError(f"{field}={getattr(self, field)!r}")

    @property
    def patches_per_side(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.patches_per_side ** 2

    @classmethod
    def from_reference_cfg(cls, video_enc_cfg: dict, img_size: int, num_frm: int, **kw):
        """Build from a ``configs/timesformer_*.json``-style dict (its
        dropout, drop-path and checkpointing fields included); ``kw`` sets
        other fields (``attn_impl``)."""
        return cls(img_size=img_size, patch_size=video_enc_cfg.get("patch_size", 16),
                   num_frames=num_frm,
                   drop_rate=video_enc_cfg.get("drop_rate", 0.0),
                   attn_drop_rate=video_enc_cfg.get("attn_drop_rate", 0.0),
                   drop_path_rate=video_enc_cfg.get("drop_path_rate", 0.1),
                   gradient_checkpointing=bool(video_enc_cfg.get("gradient_checkpointing", False)),
                   **kw)

    def kernel_fits(self, field: str, shape, dtype: torch.dtype, smem: int) -> bool:
        """Whether the kernel ``auto`` gives for ``field`` takes the block's
        tokens of ``shape`` (B, T, N, D; for the MLP tail any shape ending
        in D) with compute dtype ``dtype`` on a
        device with ``smem`` bytes of opt-in shared memory per block: the
        kernel's own limit predicate at that call site (K2 on the packed
        temporal qkv, K1 on the per-frame [cls; x] qkv, K3 on the rows)."""
        if field == "mlp_impl":
            return ln_mlp_fits(shape[-1], int(shape[-1] * self.mlp_ratio), dtype)
        B, T, N, D = shape
        H = self.num_heads
        if D % H:
            return False
        if field == "temporal_attn_impl":
            return temporal_fits(T, D // H, dtype, smem)
        return spatial_fits(B * T, 1 + N, H, D // H, dtype, smem)

    def impl(self, field: str, x: torch.Tensor, training: bool, dtype=None) -> str:
        """What ``field`` resolves to for the block's tokens ``x`` (B, T, N,
        D) at compute dtype ``dtype`` (default x's): a kernel name from
        ``_KERNEL_IMPL``, a plain form from ``_PLAIN_FORMS`` or ``plain``.
        ``auto`` gives the first kernel only in eval on a CUDA tensor and only
        where ``kernel_fits`` holds, else plain. In training (the JAX rules):
        explicit ``fused`` (MLP tail) is plain; ``cls_sideband`` is ``auto``,
        so plain; the other spatial kernel values but ``pallas`` are
        ``fused_qkv``, or plain when attention dropout is on (JAX
        ``VitAttention``); every temporal kernel value is ``fused_qkv`` (the
        kernel, unfolded projections); ``packed`` and ``circulant`` stay."""
        value = getattr(self, field)
        if value == "auto":
            use = x.device.type == "cuda" and not training and self.kernel_fits(
                field, tuple(x.shape), x.dtype if dtype is None else dtype,
                _build.smem_optin(x.device))
            value = _KERNEL_IMPL[field][0] if use else "plain"
        if value in _PLAIN_FORMS.get(field, ()):
            return value
        if value not in _KERNEL_IMPL[field]:
            return "plain"
        if not training or value == "pallas":
            return value
        if field == "temporal_attn_impl":
            return "fused_qkv"
        if field == "attn_impl" and value != "cls_sideband" and self.attn_drop_rate == 0:
            return "fused_qkv"
        return "plain"

    def joint_attn_impl(self, y: torch.Tensor, training: bool, dtype=None) -> str:
        """What a ``JointBlock``'s attention over tokens ``y`` (M, S, D)
        resolves to, by JAX ``VitAttention``'s rules on ``attn_impl``:
        ``fused_qkv`` (the spatial kernel K1 on the packed qkv, with its
        backward in training, but plain under attention dropout),
        ``pallas`` (the masked-attention kernel) or ``plain`` (every other
        value, which JAX hands to its plain attention). ``auto`` gives K1
        only in eval on a CUDA tensor where ``spatial_fits`` takes (M, S)
        at the compute dtype ``dtype`` (default y's), else plain."""
        value = self.attn_impl
        if value == "auto":
            M, S, D = y.shape
            H = self.num_heads
            use = (y.device.type == "cuda" and not training and D % H == 0
                   and spatial_fits(M, S, H, D // H, y.dtype if dtype is None else dtype,
                                    _build.smem_optin(y.device)))
            return "fused_qkv" if use else "plain"
        if value == "fused_qkv":
            return "plain" if training and self.attn_drop_rate > 0 else value
        return value if value == "pallas" else "plain"

    def drop_path_rates(self) -> list:
        """Per-block stochastic-depth rates, linspace(0, drop_path_rate, depth)."""
        return [self.drop_path_rate * i / max(self.depth - 1, 1) for i in range(self.depth)]


def _nearest_index(old_len: int, new_len: int, device) -> torch.Tensor:
    """torch F.interpolate 'nearest' indices: floor(i · old / new), in fp32
    like the JAX package."""
    pos = torch.arange(new_len, dtype=torch.float32, device=device)
    return torch.floor(pos * (old_len / new_len)).long()


class Attention(nn.Module):
    """qkv (D→3D) and proj (D→D) of one attention (ALPRO ``attn.qkv``/``attn.proj``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def plain(self, x: torch.Tensor, num_heads: int, dtype, impl: str = "xla",
              attn_drop: float = 0.0, generator=None, training: bool = False) -> torch.Tensor:
        """qkv → attention (``ops/attention.py``, ``impl`` 'xla' or 'pallas')
        → proj over x (M, S, D)."""
        M, S, D = x.shape
        qkv = linear(x, self.qkv, dtype).reshape(M, S, 3, num_heads, D // num_heads)
        out = multi_head_attention_bshd(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], impl=impl,
                                        dropout_rate=attn_drop, generator=generator,
                                        training=training)
        return linear(out.reshape(M, S, D), self.proj, dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, dtype, rate: float = 0.0, generator=None,
                training: bool = False) -> torch.Tensor:
        """Plain fc1 → exact GELU → dropout → fc2 → dropout."""
        h = dropout(gelu_exact(linear(x, self.fc1, dtype)), rate, generator, training)
        return dropout(linear(h, self.fc2, dtype), rate, generator, training)


class DividedSTBlock(nn.Module):
    """One divided space-time block on (cls (B, 1, D), x (B, T, N, D))."""

    def __init__(self, cfg: TimeSformerConfig):
        super().__init__()
        D = cfg.embed_dim
        self.norm1 = LayerNorm(D, cfg.ln_eps)
        self.attn = Attention(D)
        self.norm2 = LayerNorm(D, cfg.ln_eps)
        self.mlp = Mlp(D, int(D * cfg.mlp_ratio))
        self.temporal_norm1 = LayerNorm(D, cfg.ln_eps)
        self.temporal_attn = Attention(D)
        self.temporal_fc = nn.Linear(D, D)

    def _folded_temporal_proj(self, dtype):
        """proj·temporal_fc as one matmul in the compute dtype, torch layout:
        (a·Wp + bp)·Wt + bt = a·(Wp Wt) + (bp Wt + bt)."""
        wt = self.temporal_fc.weight.to(dtype)
        w_eff = wt @ self.temporal_attn.proj.weight.to(dtype)
        b_eff = torch.nn.functional.linear(self.temporal_attn.proj.bias.to(dtype), wt,
                                           self.temporal_fc.bias.to(dtype))
        return w_eff, b_eff

    def _sp_temporal(self, xt, sp, cfg: TimeSformerConfig, dtype, generator):
        """The plain temporal attention of xt (B·N, T, D) with its frames
        split over mesh axis ``sp``: this process's T/SP frames attend over
        all T (``parallel/seq_parallel.py``), and the output's frames are
        gathered back, with gradient, to (B·N, T, D)."""
        T = xt.shape[1]
        if T % sp.size:
            raise ValueError(f"{T} frames do not split over sp={sp.size}")
        t = T // sp.size
        a = self.temporal_attn
        local = sharded_temporal_attention(
            xt[:, sp.rank * t:(sp.rank + 1) * t], a.qkv.weight.to(dtype), a.qkv.bias.to(dtype),
            a.proj.weight.to(dtype), a.proj.bias.to(dtype), cfg.num_heads, sp.group,
            cfg.attn_drop_rate, generator, self.training)
        return gather_frames(local, sp.group)

    def forward(self, cls, x, cfg: TimeSformerConfig, dtype, dp_rate: float = 0.0,
                generator=None, sp: Optional[MeshAxis] = None):
        """``sp``: the mesh axis the plain temporal branch splits its frames
        over (None: unsplit), resolved by the tower before any block runs,
        since a checkpointed block's recompute may run on the autograd
        engine's device thread, where the ``use_mesh`` context is unset."""
        B, T, N, D = x.shape
        H = cfg.num_heads
        train = self.training
        eps = cfg.ln_eps

        # ---- temporal attention over T at each patch location ----
        t_impl = cfg.impl("temporal_attn_impl", x, train, dtype)
        tn, tqkv = self.temporal_norm1, self.temporal_attn.qkv
        if t_impl == "fused_block":
            x = fused_temporal_block(x, tn.weight, tn.bias, tqkv.weight.to(dtype),
                                     tqkv.bias.to(dtype), *self._folded_temporal_proj(dtype), H,
                                     eps=eps)
        elif t_impl == "fused_qkv_proj":
            qkv = linear(tn(x, dtype), tqkv, dtype)              # (B, T, N, 3D)
            y = temporal_attention_qkv_proj(qkv, *self._folded_temporal_proj(dtype), H)
            x = x + y.to(x.dtype)
        elif t_impl in ("fused_qkv_fold", "fused_ln_qkv"):
            if t_impl == "fused_ln_qkv":
                qkv = ln_matmul(x, tn.weight, tn.bias, tqkv.weight.to(dtype),
                                tqkv.bias.to(dtype), eps=eps)
            else:
                qkv = linear(tn(x, dtype), tqkv, dtype)          # (B, T, N, 3D)
            t_att = temporal_attention_qkv(qkv, H)
            x = x + torch.nn.functional.linear(
                t_att, *self._folded_temporal_proj(dtype)).to(x.dtype)
        else:
            def temporal():
                xt = tn(x, dtype)
                if t_impl in _TEMPORAL_FORMS:  # the kernel or a plain form, unfolded projections
                    t_att = _TEMPORAL_FORMS[t_impl](linear(xt, tqkv, dtype), H)
                    t_out = linear(t_att, self.temporal_attn.proj, dtype)
                else:
                    xt = xt.permute(0, 2, 1, 3).reshape(B * N, T, D)
                    if sp is not None:
                        t_out = self._sp_temporal(xt, sp, cfg, dtype, generator)
                    else:
                        t_out = self.temporal_attn.plain(xt, H, dtype, "xla",
                                                         cfg.attn_drop_rate, generator, train)
                    t_out = t_out.reshape(B, N, T, D).permute(0, 2, 1, 3)
                return dropout(t_out, cfg.drop_rate, generator, train)

            t_out = checkpoint_name(TS_TEMPORAL_ATTN, temporal)
            t_out = drop_path(t_out, dp_rate, (B, 1, N, 1), generator, train)
            x = x + linear(t_out, self.temporal_fc, dtype)

        # ---- spatial attention over [cls; N patches] per frame ----
        s_impl = cfg.impl("attn_impl", x, train, dtype)
        n1, sqkv, proj = self.norm1, self.attn.qkv, self.attn.proj
        if s_impl == "cls_sideband":  # eval only: no concat, CLS qkv once per sample
            qkv_x = linear(n1(x, dtype), sqkv, dtype).reshape(B * T, N, 3 * D)
            qkv_c = linear(n1(cls, dtype), sqkv, dtype)             # (B, 1, 3D)
            att_x, att_c = spatial_attention_qkv_cls(qkv_x, qkv_c, H, T)
            x = x + linear(att_x, proj, dtype).to(x.dtype).reshape(B, T, N, D)
            # the frame mean of the CLS outputs in fp32, then one projection
            c_mean = att_c.reshape(B, T, D).float().mean(dim=1, keepdim=True).to(dtype)
            cls = cls + linear(c_mean, proj, dtype).to(cls.dtype)
            return self._mlp_tail(cls, x, cfg, dtype, dp_rate, generator)
        cls_rep = cls[:, None].expand(B, T, 1, D).to(x.dtype)
        xs = torch.cat([cls_rep, x], dim=2).reshape(B * T, 1 + N, D)

        def spatial():
            if s_impl == "fused_qkv_proj":
                qkv = linear(n1(xs, dtype), sqkv, dtype)
                s_out = spatial_attention_qkv_proj(qkv, proj.weight.to(dtype),
                                                   proj.bias.to(dtype), H)
            elif s_impl == "fused_block":
                s_out = fused_spatial_block(xs, n1.weight, n1.bias, sqkv.weight.to(dtype),
                                            sqkv.bias.to(dtype), proj.weight.to(dtype),
                                            proj.bias.to(dtype), H, eps=eps)
            elif s_impl in ("fused_qkv", "fused_ln_qkv"):
                if s_impl == "fused_ln_qkv":
                    qkv = ln_matmul(xs, n1.weight, n1.bias, sqkv.weight.to(dtype),
                                    sqkv.bias.to(dtype), eps=eps)
                else:
                    qkv = linear(n1(xs, dtype), sqkv, dtype)
                s_out = linear(spatial_attention_qkv(qkv, H), proj, dtype)
            else:
                s_out = self.attn.plain(n1(xs, dtype), H, dtype,
                                        "pallas" if s_impl == "pallas" else "xla",
                                        cfg.attn_drop_rate, generator, train)
            return dropout(s_out, cfg.drop_rate, generator, train).reshape(B, T, 1 + N, D)

        s_out = checkpoint_name(TS_SPATIAL_ATTN, spatial)
        s_out = drop_path(s_out, dp_rate, (B, T, 1, 1), generator, train)
        cls = cls + s_out[:, :, 0, :].mean(dim=1, keepdim=True)
        x = x + s_out[:, :, 1:, :]
        return self._mlp_tail(cls, x, cfg, dtype, dp_rate, generator)

    def _mlp_tail(self, cls, x, cfg: TimeSformerConfig, dtype, dp_rate: float, generator):
        """LN → MLP → residual on the patches and the CLS, one per-sample
        drop-path mask for both."""
        B, T, N, D = x.shape
        train = self.training
        if cfg.impl("mlp_impl", x, train, dtype) == "fused":
            args = (
                self.norm2.weight, self.norm2.bias,
                self.mlp.fc1.weight.to(dtype), self.mlp.fc1.bias.to(dtype),
                self.mlp.fc2.weight.to(dtype), self.mlp.fc2.bias.to(dtype),
            )
            x = ln_mlp(x.reshape(B * T * N, D), *args, eps=cfg.ln_eps).reshape(B, T, N, D)
            cls = ln_mlp(cls.reshape(B, D), *args, eps=cfg.ln_eps).reshape(B, 1, D)
            return cls, x
        mlp_cls = self.mlp(self.norm2(cls, dtype), dtype, cfg.drop_rate, generator, train)
        mlp_x = self.mlp(self.norm2(x, dtype), dtype, cfg.drop_rate, generator, train)
        if train and dp_rate > 0.0:  # one per-sample mask for cls and patches
            keep = drop_path(torch.ones((B, 1, 1), dtype=x.dtype, device=x.device), dp_rate,
                             (B, 1, 1), generator, train)
            mlp_cls = mlp_cls * keep
            mlp_x = mlp_x * keep[:, :, None, :]
        return cls + mlp_cls, x + mlp_x


class JointBlock(nn.Module):
    """The pre-norm ViT block of the joint and space-only attention types
    (JAX ``JointBlock``) on tokens y (M, S, D): y + drop_path(attn(norm1(y))),
    then y + drop_path(mlp(norm2(y))), one drop-path mask per row of M for
    each. The attention resolves by ``TimeSformerConfig.joint_attn_impl``;
    the MLP tail by ``mlp_impl`` as the divided block's does (K3 in eval
    where ``ln_mlp_fits``; it computes exactly that tail), where JAX's
    ``JointBlock`` runs its plain MLP whatever ``mlp_impl`` says."""

    def __init__(self, cfg: TimeSformerConfig):
        super().__init__()
        D = cfg.embed_dim
        self.norm1 = LayerNorm(D, cfg.ln_eps)
        self.attn = Attention(D)
        self.norm2 = LayerNorm(D, cfg.ln_eps)
        self.mlp = Mlp(D, int(D * cfg.mlp_ratio))

    def forward(self, y, cfg: TimeSformerConfig, dtype, dp_rate: float = 0.0, generator=None):
        M, S, D = y.shape
        H, train = cfg.num_heads, self.training
        impl = cfg.joint_attn_impl(y, train, dtype)
        yn = self.norm1(y, dtype)
        if impl == "fused_qkv":
            a = linear(spatial_attention_qkv(linear(yn, self.attn.qkv, dtype), H), self.attn.proj,
                       dtype)
        else:
            a = self.attn.plain(yn, H, dtype, "pallas" if impl == "pallas" else "xla",
                                cfg.attn_drop_rate, generator, train)
        a = dropout(a, cfg.drop_rate, generator, train)
        y = y + drop_path(a, dp_rate, (M, 1, 1), generator, train).to(y.dtype)
        if cfg.impl("mlp_impl", y, train, dtype) == "fused":
            mlp = self.mlp
            return ln_mlp(y.reshape(M * S, D), self.norm2.weight, self.norm2.bias,
                          mlp.fc1.weight.to(dtype), mlp.fc1.bias.to(dtype),
                          mlp.fc2.weight.to(dtype), mlp.fc2.bias.to(dtype),
                          eps=cfg.ln_eps).reshape(M, S, D)
        m = self.mlp(self.norm2(y, dtype), dtype, cfg.drop_rate, generator, train)
        return y + drop_path(m, dp_rate, (M, 1, 1), generator, train).to(y.dtype)


class PatchEmbed(nn.Module):
    """Patch embedding as a (p·p·C, D) matmul over (ph, pw, c)-ordered patch
    vectors (the ALPRO strided conv, ``checkpoint/load.py`` converts)."""

    def __init__(self, cfg: TimeSformerConfig):
        super().__init__()
        self.cfg = cfg
        self.kernel = nn.Parameter(torch.zeros(cfg.patch_size ** 2 * 3, cfg.embed_dim))
        self.bias = nn.Parameter(torch.zeros(cfg.embed_dim))

    def forward(self, patches: torch.Tensor, dtype, uint8_norm: bool = False):
        if uint8_norm:
            # norm(v) @ W + b = v @ (a ⊙ W) + (c @ W + b), with per-column
            # a_k = 1/(255·std_{k%C}), c_k = -mean_{k%C}/std_{k%C}
            p = self.cfg.patch_size
            mean = torch.tensor(self.cfg.pixel_mean, device=patches.device)
            std = torch.tensor(self.cfg.pixel_std, device=patches.device)
            a = (1.0 / (255.0 * std)).repeat(p * p)
            c = (-mean / std).repeat(p * p)
            kernel = self.kernel.float()
            w_eff = (kernel * a[:, None]).to(dtype)
            b_eff = (self.bias.float() + c @ kernel).to(dtype)
            return patches.to(dtype) @ w_eff + b_eff
        return patches.to(dtype) @ self.kernel.to(dtype) + self.bias.to(dtype)


class TimeSformer(nn.Module):
    def __init__(self, cfg: TimeSformerConfig, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        D = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_patches + 1, D))
        self.time_embed = nn.Parameter(torch.zeros(1, cfg.num_frames, D))
        block = DividedSTBlock if cfg.attention_type == "divided_space_time" else JointBlock
        self.blocks = nn.ModuleList(block(cfg) for _ in range(cfg.depth))
        self.norm = LayerNorm(D, cfg.ln_eps)
        self.eval()  # deterministic until train(), as the JAX default

    def _embed_patches(self, pixels: torch.Tensor):
        """The three input forms → ((B, T, N, D) tokens, hp, wp)."""
        cfg, dt = self.cfg, self.dtype
        p = cfg.patch_size
        fold = cfg.fold_uint8_norm == "on" or (
            cfg.fold_uint8_norm == "auto" and dt == torch.bfloat16
        )
        if pixels.dim() == 4:  # pre-patchified (B, T, N, p·p·C)
            side = int(round(pixels.shape[2] ** 0.5))
            if pixels.dtype == torch.uint8:
                if fold:
                    return self.patch_embed(pixels, dt, uint8_norm=True), side, side
                # per-column stats: column k ↔ channel k % C
                v = _normalize(pixels, tuple(cfg.pixel_mean) * (p * p),
                               tuple(cfg.pixel_std) * (p * p))
                return self.patch_embed(v, dt), side, side
            return self.patch_embed(pixels, dt), side, side
        if pixels.dim() != 5:
            raise ValueError(
                f"pixels must be (B, T, H, W, C) or (B, T, N, p·p·C), got {tuple(pixels.shape)}"
            )
        B, T, H, W, C = pixels.shape
        hp, wp = H // p, W // p
        if pixels.dtype == torch.uint8 and cfg.fused_patchify == "on":
            pe = self.patch_embed
            return (patchify_embed(pixels, pe.kernel.to(dt), pe.bias.to(dt), cfg.pixel_mean,
                                   cfg.pixel_std), hp, wp)
        uint8_fold = pixels.dtype == torch.uint8 and fold
        if pixels.dtype == torch.uint8 and not fold:
            pixels = _normalize(pixels, cfg.pixel_mean, cfg.pixel_std)
        # patch extraction in (ph, pw, c) order (the reference's strided conv)
        v = pixels.reshape(B, T, hp, p, wp, p, C).permute(0, 1, 2, 4, 3, 5, 6)
        v = v.reshape(B, T, hp * wp, p * p * C)
        return self.patch_embed(v, dt, uint8_norm=uint8_fold), hp, wp

    def forward(self, pixels: torch.Tensor, generator: Optional[torch.Generator] = None,
                pooling: str = "temporal") -> torch.Tensor:
        """pixels: (B, T, H, W, 3) uint8 or normalized float, or pre-patchified
        (B, T, N, p·p·3) uint8/float. After the final LN, ``pooling``
        'temporal' returns (B, 1+N, D) (the patches' mean over frames),
        'spatial' (B, 1+T, D) (each frame's mean over patches) and 'none'
        (B, T, 1+N, D) (the CLS repeated per frame); under ``space_only``
        the blocks' frame mean leaves T = 1. In training, dropout and
        drop-path masks come from ``generator`` (on the activations'
        device)."""
        if pooling not in POOLINGS:
            raise ValueError(f"pooling={pooling!r}: expected one of {POOLINGS}")
        cfg, dt, train = self.cfg, self.dtype, self.training
        D = cfg.embed_dim
        x, hp, wp = self._embed_patches(pixels)
        B, T, N, _ = x.shape

        pos_cls, pos_patch = self.pos_embed[:, :1], self.pos_embed[:, 1:]
        if N != cfg.num_patches:
            side = cfg.patches_per_side
            grid = pos_patch.reshape(1, side, side, D)
            grid = grid[:, _nearest_index(side, hp, grid.device)]
            grid = grid[:, :, _nearest_index(side, wp, grid.device)]
            pos_patch = grid.reshape(1, N, D)
        te = self.time_embed
        if T != cfg.num_frames:
            te = te[:, _nearest_index(cfg.num_frames, T, te.device)]

        cls = (self.cls_token + pos_cls).to(dt).expand(B, 1, D).contiguous()
        x = dropout(x + pos_patch[:, None].to(x.dtype), cfg.drop_rate, generator, train)
        cls = dropout(cls, cfg.drop_rate, generator, train)
        if cfg.attention_type != "space_only":
            x = dropout(x + te[:, :, None, :].to(x.dtype), cfg.drop_rate, generator, train)
        rates = cfg.drop_path_rates()
        if cfg.attention_type == "joint_space_time":
            y = torch.cat([cls.to(x.dtype), x.reshape(B, T * N, D)], dim=1)
            for blk, rate in zip(self.blocks, rates):
                y = blk(y, cfg, dt, rate, generator)
            cls, x = y[:, :1], y[:, 1:].reshape(B, T, N, D)
        elif cfg.attention_type == "space_only":
            # each frame alone, then the mean over frames of every token, CLS included
            cls_rep = cls[:, None].expand(B, T, 1, D).to(x.dtype)
            y = torch.cat([cls_rep, x], dim=2).reshape(B * T, 1 + N, D)
            for blk, rate in zip(self.blocks, rates):
                y = blk(y, cfg, dt, rate, generator)
            y = y.reshape(B, T, 1 + N, D).mean(dim=1)
            cls, x, T = y[:, :1], y[:, None, 1:], 1
        else:
            remat = train and cfg.gradient_checkpointing and torch.is_grad_enabled()
            context_fn = resolve_remat_policy(cfg.remat_policy) if remat else None
            sp = active_axis(cfg.sp_axis)
            for blk, rate in zip(self.blocks, rates):
                if remat:
                    cls, x = checkpoint(
                        lambda c, v, blk=blk, rate=rate: blk(c, v, cfg, dt, rate, generator, sp),
                        generator, cls, x, context_fn=context_fn)
                else:
                    cls, x = blk(cls, x, cfg, dt, rate, generator, sp)
        cls = self.norm(cls, dt)
        x = self.norm(x, dt)
        if pooling == "temporal":
            return torch.cat([cls, x.mean(dim=1)], dim=1)
        if pooling == "spatial":
            return torch.cat([cls, x.mean(dim=2)], dim=1)
        return torch.cat([cls[:, None].expand(B, T, 1, D), x], dim=2)
