"""Flash attention on the card: the Hopper kernels' entry points, their
plain versions, and the autograd rule that ties them together.

``flash_fwd(q, k, v, *, causal, window)`` computes causal / sliding-window
GQA attention over q ``[B, S, H, D]`` and k, v ``[B, T, KVH, D]`` with
query positions ``0..S-1`` and key positions ``0..T-1``, and returns
``(o, m, l)``: ``o [B, S, H, D]`` in q's dtype, and the online softmax's
row maximum ``m`` and row sum ``l`` as ``[B, H, S, 1]`` f32, as the Pallas
kernel of the JAX package returns them (so the backward reuses them).
Query head ``h`` reads kv head ``h // (H // KVH)``.  A key ``t`` is
visible to a query ``s`` when ``t <= s`` (causal) and ``t > s - window``
(``window > 0``); a row with no visible key gets ``o = 0``, ``m = -2e38``,
``l = 0``.

``flash_bwd(q, k, v, o, m, l, do, *, causal, window)`` returns
``(dq, dk, dv)`` in the inputs' dtypes, recomputing the probabilities from
``(m, l)``; ``dk`` and ``dv`` sum over the query heads of each kv head,
and an empty row gets ``dq = 0``.

``FlashAttention`` (a ``torch.autograd.Function``, the counterpart of the
JAX package's ``jax.custom_vjp`` ``flash_attention_kernel``) runs
``flash_fwd`` forward, saves ``(q, k, v, o, m, l)``, and runs ``flash_bwd``
backward; ``flash_attention_kernel(q, k, v, causal, window)`` applies it.
Under ``torch.utils.checkpoint`` the recompute runs the forward again and
saves that pass's tensors.

A CUDA tensor launches the hand-written kernels (``kernels/csrc/
flash_fwd.cu`` and ``flash_bwd.cu`` through ``kernels.cuda``); a CPU
tensor takes the plain versions beside them, dense masked softmaxes in f32
(f64 for f64 inputs).  ``flash_fwd`` and ``flash_bwd`` record no autograd
graph on either device: gradients go through ``FlashAttention``.

Both are custom operators, ``torch.ops.repro_torch.flash_fwd`` and
``flash_bwd`` (``torch.library.custom_op``): a CUDA kernel, a CPU kernel
(the plain version), any other device refused; a fake implementation
that gives the outputs' shapes and dtypes only, so under
``FakeTensorMode`` (the dry-run, ``launch/dryrun.py``) each call is one op
with the kernel's own outputs and no score matrix; and a flop formula
(``torch.utils.flop_counter``), 4·D flops a visible (query, key) pair
forward and 10·D backward, the count the kernels' bound uses, on either
device.  ``hbm_bytes`` is the JAX package's HBM contract of the kernel.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

NEG_INF = -2.0e38


def _visible(s_len: int, t_len: int, causal: bool, window: int,
             qpos=None, kpos=None, device=None) -> torch.Tensor:
    """Mask of visible (query, key) pairs, [1 or B, S, T], from positions
    ``0..S-1``/``0..T-1`` or from ``qpos [B, S]`` and ``kpos [B, T]``."""
    if qpos is None:
        qpos = torch.arange(s_len, device=device)[None]
    if kpos is None:
        kpos = torch.arange(t_len, device=device)[None]
    dq, dk = qpos[:, :, None], kpos[:, None, :]
    mask = torch.ones((1, s_len, t_len), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (dk <= dq)
    if window > 0:
        mask = mask & (dk > dq - window)
    return mask


def _flash_fwd_ref(q, k, v, *, causal: bool = True, window: int = 0,
                   qpos=None, kpos=None, p_dtype=None):
    """The plain version: dense masked softmax in f32 (f64 for f64
    inputs), GQA by head index.

    ``qpos``/``kpos`` default to ``0..S-1``/``0..T-1``.  ``p_dtype`` rounds
    the probabilities to that dtype before the ``PV`` product, as the JAX
    package's jnp flash does with the value dtype (the Pallas kernel, and
    the CUDA kernel, keep them in f32)."""
    b, s_len, nq, d = q.shape
    t_len, nkv = k.shape[1], k.shape[2]
    heads = torch.arange(nq, device=q.device) // (nq // nkv)
    acc = _acc_dtype(q)
    qf = q.to(acc)
    kf = k.to(acc)[:, :, heads]                       # [B, T, H, D]
    vf = v.to(acc)[:, :, heads]
    s = torch.einsum("bshd,bthd->bhst", qf, kf) * (1.0 / d ** 0.5)
    mask = _visible(s_len, t_len, causal, window, qpos, kpos, q.device)
    s = torch.where(mask[:, None], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)                  # [B, H, S, 1]
    safe = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.exp(s - safe)
    l = p.sum(dim=-1, keepdim=True)
    if p_dtype is not None:
        p = p.to(p_dtype).to(acc)
    o = torch.einsum("bhst,bthd->bshd", p, vf)
    o = o / torch.clamp(l, min=1e-30).permute(0, 2, 1, 3)
    return o.to(q.dtype), m, l


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """The plain versions' working dtype: f32, or f64 for f64 inputs."""
    return torch.promote_types(x.dtype, torch.float32)


def _flash_bwd_ref(q, k, v, o, m, l, do, *, causal: bool = True,
                   window: int = 0):
    """The plain backward: the Pallas kernels' recompute-from-(m, l) math,
    dense.  ``p = where(mask, exp(s - safe_m), 0) / max(l, 1e-30)``,
    ``delta = sum_D o do``, ``ds = p (dp - delta)``; ``dq = ds k scale``,
    ``dk = ds^T q scale``, ``dv = p^T do``, the query heads of each kv head
    summed.  Results in the inputs' dtypes."""
    b, s_len, nq, d = q.shape
    t_len, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    heads = torch.arange(nq, device=q.device) // g
    acc = _acc_dtype(q)
    scale = 1.0 / d ** 0.5
    qf, dof = q.to(acc), do.to(acc)
    kf = k.to(acc)[:, :, heads]                       # [B, T, H, D]
    vf = v.to(acc)[:, :, heads]
    s = torch.einsum("bshd,bthd->bhst", qf, kf) * scale
    mask = _visible(s_len, t_len, causal, window, device=q.device)[:, None]
    m, l = m.to(acc), l.to(acc)
    safe = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.where(mask, torch.exp(s - safe), torch.zeros_like(s))
    p = p / torch.clamp(l, min=1e-30)
    delta = (o.to(acc) * dof).sum(-1).transpose(1, 2)[..., None]
    dp = torch.einsum("bshd,bthd->bhst", dof, vf)
    ds = p * (dp - delta)
    dq = torch.einsum("bhst,bthd->bshd", ds, kf) * scale
    dk = torch.einsum("bhst,bshd->bthd", ds, qf) * scale
    dv = torch.einsum("bhst,bshd->bthd", p, dof)
    dk = dk.reshape(b, t_len, nkv, g, d).sum(3)
    dv = dv.reshape(b, t_len, nkv, g, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_operands(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_fwd: q, k, v must be [B, S, H, D] / "
                         "[B, T, KVH, D]")
    b, _, nq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_fwd: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if nq % k.shape[2]:
        raise ValueError(f"flash_fwd: {nq} query heads are not a multiple "
                         f"of {k.shape[2]} kv heads")


@torch.library.custom_op("repro_torch::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, window: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    raise ValueError(f"flash_fwd: unsupported device {q.device}")


@_flash_fwd_op.register_kernel("cuda")
def _(q, k, v, causal, window):
    from repro_torch.kernels import cuda
    return cuda.flash_fwd(q, k, v, causal=causal, window=window)


@_flash_fwd_op.register_kernel("cpu")
def _(q, k, v, causal, window):
    return _flash_fwd_ref(q, k, v, causal=causal, window=window)


@_flash_fwd_op.register_fake
def _(q, k, v, causal, window):
    b, s_len, h, _ = q.shape
    stats = q.new_empty((b, h, s_len, 1), dtype=_acc_dtype(q))
    return torch.empty_like(q), stats, torch.empty_like(stats)


@torch.library.custom_op("repro_torch::flash_bwd", mutates_args=())
def _flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                  do: torch.Tensor, causal: bool, window: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    raise ValueError(f"flash_bwd: unsupported device {q.device}")


@_flash_bwd_op.register_kernel("cuda")
def _(q, k, v, o, m, l, do, causal, window):
    from repro_torch.kernels import cuda
    return cuda.flash_bwd(q, k, v, o, m, l, do, causal=causal,
                          window=window)


@_flash_bwd_op.register_kernel("cpu")
def _(q, k, v, o, m, l, do, causal, window):
    return _flash_bwd_ref(q, k, v, o, m, l, do, causal=causal,
                          window=window)


@_flash_bwd_op.register_fake
def _(q, k, v, o, m, l, do, causal, window):
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            torch.empty_like(k, memory_format=torch.contiguous_format),
            torch.empty_like(v, memory_format=torch.contiguous_format))


def visible_pairs(s_len: int, t_len: int, causal: bool, window: int) -> int:
    """The (query, key) pairs a row of one head sees: query positions
    ``0..S-1``, key positions ``0..T-1``, the mask of ``_visible``."""
    s = np.arange(s_len, dtype=np.int64)
    hi = np.minimum(s, t_len - 1) if causal else np.full_like(s, t_len - 1)
    lo = np.maximum(s - window + 1, 0) if window > 0 else np.zeros_like(s)
    return int(np.maximum(hi - lo + 1, 0).sum())


@register_flop_formula(torch.ops.repro_torch.flash_fwd)
def _flash_fwd_flops(q_shape, k_shape, v_shape, causal, window, *args,
                     **kwargs) -> int:
    b, s_len, h, d = q_shape
    return 4 * d * b * h * visible_pairs(s_len, k_shape[1], causal, window)


@register_flop_formula(torch.ops.repro_torch.flash_bwd)
def _flash_bwd_flops(q_shape, k_shape, *args, **kwargs) -> int:
    b, s_len, h, d = q_shape
    causal, window = args[-2:]
    return 10 * d * b * h * visible_pairs(s_len, k_shape[1], causal, window)


def flash_fwd(q, k, v, *, causal: bool = True, window: int = 0):
    """-> (o [B,S,H,D] in q's dtype, m [B,H,S,1] f32, l [B,H,S,1] f32)."""
    _check_operands(q, k, v)
    with torch.no_grad():
        return _flash_fwd_op(q, k, v, causal, window)


def flash_bwd(q, k, v, o, m, l, do, *, causal: bool = True,
              window: int = 0):
    """-> (dq [B,S,H,D], dk [B,T,KVH,D], dv [B,T,KVH,D]) in the inputs'
    dtypes, from the forward's o, m, l and the output gradient do."""
    _check_operands(q, k, v)
    with torch.no_grad():
        return _flash_bwd_op(q, k, v, o, m, l, do, causal, window)


class FlashAttention(torch.autograd.Function):
    """o = attention(q, k, v): ``flash_fwd`` forward, ``flash_bwd``
    backward on the saved ``(q, k, v, o, m, l)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        o, m, l = flash_fwd(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o, m, l)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, m, l = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, m, l, do.contiguous(),
                               causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention_kernel(q, k, v, causal: bool = True, window: int = 0):
    """Differentiable attention through ``FlashAttention`` -> o."""
    return FlashAttention.apply(q, k, v, causal, window)


def hbm_bytes(cfg, batch: int, seq: int, *, train: bool) -> float:
    """The kernel's HBM traffic contract (per layer, per device inputs):
    fwd reads q,k,v (+stats) and writes o; bwd reads q,k,v,o,do and writes
    dq,dk,dv.  The JAX package's formula (bf16 operands), which the
    dry-run reports beside the flash ops' own traffic."""
    bt = 2  # bf16
    qo = batch * seq * cfg.n_heads * cfg.head_dim * bt
    kv = batch * seq * cfg.n_kv_heads * cfg.head_dim * bt
    fwd = 2 * qo + 2 * kv + 2 * (batch * seq * cfg.n_heads * 4) * 2
    if not train:
        return fwd
    bwd = 3 * qo + 2 * kv + (qo + 2 * kv)      # q,o,do reads + dq,dk,dv
    return fwd + bwd
