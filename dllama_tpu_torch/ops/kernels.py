"""Elementwise / normalization / RoPE ops — the port of
``dllama_tpu/ops/kernels.py``.

Plain PyTorch functions on tensors (the JAX package leaves these to XLA;
none of them is a Pallas kernel).  Numerics follow the JAX functions:

* rmsnorm accumulates the sum of squares in f32 and places eps *after*
  the mean: ``1/sqrt(mean(x²) + 1e-5)``, then casts back to x's dtype.
* gelu is the tanh approximation.
* top-k breaks ties toward the lower index, as ``jax.lax.top_k`` does.
* RoPE has two conventions: ``interleaved`` (Llama: adjacent pairs
  (2j, 2j+1)) and rotate-half (Grok-1/Mixtral: pairs (j, j+half)); the
  rotation runs in f32 and casts back.
"""

from __future__ import annotations

import numpy as np
import torch

RMS_EPS = 1e-5


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = RMS_EPS) -> torch.Tensor:
    xf = x.to(torch.float32)
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    inv = torch.rsqrt(ms + eps)
    return (weight.to(torch.float32) * (xf * inv)).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """x · σ(x)."""
    return x * torch.sigmoid(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    xf = x.to(torch.float32)
    y = 0.5 * xf * (1.0 + torch.tanh(0.7978845608028654 * (xf + 0.044715 * xf * xf * xf)))
    return y.to(x.dtype)


ACTIVATIONS = {0: gelu_tanh, 1: silu}  # TransformerHiddenAct


def rope_freqs(head_size: int, theta: float) -> np.ndarray:
    """Frequency ``j`` is ``theta^(-2j/head_size)``, computed in numpy f32
    exactly as the JAX package does."""
    half = head_size // 2
    return 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) * 2.0 / head_size))


_FREQS: dict[tuple, torch.Tensor] = {}


def rope_angles(positions: torch.Tensor, head_size: int, theta: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables of shape ``positions.shape + (head_size/2,)``, f32.
    The frequencies go to the device once (kept per device, head size and
    theta): a forward makes no host-to-device copy, which a captured CUDA
    graph could not hold and which would wait on the device's queue."""
    key = (positions.device, head_size, float(theta))
    freqs = _FREQS.get(key)
    if freqs is None:
        freqs = _FREQS[key] = torch.from_numpy(rope_freqs(head_size, theta)).to(
            positions.device)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, *,
               interleaved: bool) -> torch.Tensor:
    """Rotate ``x`` of shape (..., n_heads, head_size); ``cos``/``sin``
    (..., head_size/2) broadcast over heads."""
    xf = x.to(torch.float32)
    c = cos[..., None, :]
    s = sin[..., None, :]
    if interleaved:
        x0 = xf[..., 0::2]
        x1 = xf[..., 1::2]
        out = torch.stack([x0 * c - x1 * s, x0 * s + x1 * c], dim=-1).reshape(x.shape)
    else:
        half = x.shape[-1] // 2
        x0 = xf[..., :half]
        x1 = xf[..., half:]
        out = torch.cat([x0 * c - x1 * s, x0 * s + x1 * c], dim=-1)
    return out.to(x.dtype)


def softmax_f32(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Max-shifted softmax in f32."""
    xf = x.to(torch.float32)
    m = torch.amax(xf, dim=dim, keepdim=True)
    e = torch.exp(xf - m)
    return e / torch.sum(e, dim=dim, keepdim=True)


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values along the last axis and their indices,
    largest first, equal values in ascending index order — the order of
    ``jax.lax.top_k`` (``torch.topk`` promises none).  A stable descending
    sort, cut to ``k``; it runs on the device with no host read."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
