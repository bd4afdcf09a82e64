"""Int8 error-feedback gradient compression for the slow (cross-pod) axis.

Quantizing a cross-pod gradient reduction 4x (f32 -> int8 + a per-tensor
scale) cuts its traffic while error feedback keeps the accumulated
quantization error in the update path (Seide et al. 2014).  Plain
functions over lists of tensors, as the JAX package's are over pytrees;
no launcher uses them yet, on either side:

    residual = ef_init(grads)
    q, scales, residual = compress_grads(grads, residual)
    grads = decompress_grads(q, scales)

``simulate_roundtrip`` applies compress -> decompress locally.
"""

from __future__ import annotations

import torch


def ef_init(grads: list) -> list:
    return [torch.zeros_like(g, dtype=torch.float32) for g in grads]


def _q8(x: torch.Tensor):
    """Symmetric per-tensor int8 quantization: (q, scale)."""
    amax = torch.max(torch.abs(x))
    scale = torch.where(amax > 0, amax / 127.0,
                        torch.ones_like(amax)).to(torch.float32)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dq8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_grads(grads: list, residual: list):
    """(q list, scales list, new residual): error feedback folds the
    quantization error of this step into the next step's gradient."""
    qs, scales, errs = [], [], []
    for g, r in zip(grads, residual):
        v = g.to(torch.float32) + r
        q, s = _q8(v)
        qs.append(q)
        scales.append(s)
        errs.append(v - _dq8(q, s))
    return qs, scales, errs


def decompress_grads(qs: list, scales: list) -> list:
    return [_dq8(q, s) for q, s in zip(qs, scales)]


def simulate_roundtrip(grads: list, residual: list):
    """Local compress -> decompress (what each pod sees after the quantized
    cross-pod reduction, modulo the mean)."""
    q, s, r = compress_grads(grads, residual)
    return decompress_grads(q, s), r
