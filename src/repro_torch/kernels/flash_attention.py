"""Flash-attention forward: the Hopper kernel's entry point and its plain
version.

``flash_fwd(q, k, v, *, causal, window)`` computes causal / sliding-window
GQA attention over q ``[B, S, H, D]`` and k, v ``[B, T, KVH, D]`` with
query positions ``0..S-1`` and key positions ``0..T-1``, and returns
``(o, m, l)``: ``o [B, S, H, D]`` in q's dtype, and the online softmax's
row maximum ``m`` and row sum ``l`` as ``[B, H, S, 1]`` f32, as the Pallas
kernel of the JAX package returns them (so a backward pass can reuse
them).  Query head ``h`` reads kv head ``h // (H // KVH)``.  A key ``t``
is visible to a query ``s`` when ``t <= s`` (causal) and ``t > s - window``
(``window > 0``); a row with no visible key gets ``o = 0``, ``m = -2e38``,
``l = 0``.

A CUDA tensor launches the hand-written kernel (``kernels/csrc/
flash_fwd.cu`` through ``kernels.cuda.flash_fwd``); a CPU tensor takes
``_flash_fwd_ref`` beside it, a dense f32 masked softmax.  There is no
autograd rule yet: a tensor that requires grad is refused.
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
    """The plain version: dense f32 masked softmax, GQA by head index.

    ``qpos``/``kpos`` default to ``0..S-1``/``0..T-1``.  ``p_dtype`` rounds
    the probabilities to that dtype before the ``PV`` product, as the JAX
    package's jnp flash does with the value dtype (the Pallas kernel, and
    the CUDA kernel, keep them in f32)."""
    b, s_len, nq, d = q.shape
    t_len, nkv = k.shape[1], k.shape[2]
    heads = torch.arange(nq, device=q.device) // (nq // nkv)
    qf = q.float()
    kf = k.float()[:, :, heads]                       # [B, T, H, D]
    vf = v.float()[:, :, heads]
    s = torch.einsum("bshd,bthd->bhst", qf, kf) * (1.0 / d ** 0.5)
    mask = _visible(s_len, t_len, causal, window, qpos, kpos, q.device)
    s = torch.where(mask[:, None], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)                  # [B, H, S, 1]
    safe = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.exp(s - safe)
    l = p.sum(dim=-1, keepdim=True)
    if p_dtype is not None:
        p = p.to(p_dtype).float()
    o = torch.einsum("bhst,bthd->bshd", p, vf)
    o = o / torch.clamp(l, min=1e-30).permute(0, 2, 1, 3)
    return o.to(q.dtype), m, l


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
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise RuntimeError(
            "flash_fwd has no backward yet: the flash backward kernel and "
            "its torch.autograd.Function come with the training slice "
            "(ROADMAP Queue A, item 1); run the serving path under "
            "torch.no_grad()")


def flash_fwd(q, k, v, *, causal: bool = True, window: int = 0):
    """-> (o [B,S,H,D] in q's dtype, m [B,H,S,1] f32, l [B,H,S,1] f32)."""
    _check_operands(q, k, v)
    if q.device.type == "cuda":
        from repro_torch.kernels import cuda
        return cuda.flash_fwd(q, k, v, causal=causal, window=window)
    if q.device.type != "cpu":
        raise ValueError(f"flash_fwd: unsupported device {q.device}")
    return _flash_fwd_ref(q, k, v, causal=causal, window=window)
