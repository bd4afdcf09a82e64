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
"""

from __future__ import annotations

import torch

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


def _route(op: str, x: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernel), False for a CPU one."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{op}: unsupported device {x.device}")
    return x.device.type == "cuda"


def flash_fwd(q, k, v, *, causal: bool = True, window: int = 0):
    """-> (o [B,S,H,D] in q's dtype, m [B,H,S,1] f32, l [B,H,S,1] f32)."""
    _check_operands(q, k, v)
    if _route("flash_fwd", q):
        from repro_torch.kernels import cuda
        return cuda.flash_fwd(q, k, v, causal=causal, window=window)
    with torch.no_grad():
        return _flash_fwd_ref(q, k, v, causal=causal, window=window)


def flash_bwd(q, k, v, o, m, l, do, *, causal: bool = True,
              window: int = 0):
    """-> (dq [B,S,H,D], dk [B,T,KVH,D], dv [B,T,KVH,D]) in the inputs'
    dtypes, from the forward's o, m, l and the output gradient do."""
    _check_operands(q, k, v)
    if _route("flash_bwd", q):
        from repro_torch.kernels import cuda
        return cuda.flash_bwd(q, k, v, o, m, l, do, causal=causal,
                              window=window)
    with torch.no_grad():
        return _flash_bwd_ref(q, k, v, o, m, l, do, causal=causal,
                              window=window)


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
