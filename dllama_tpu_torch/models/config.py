"""Model configuration — the port of ``dllama_tpu/models/config.py``.

Bridges the `.m` header (``ModelSpec``) to the runtime: adds the compute
dtype (a torch dtype) and the per-arch structural flags.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ..io import mfile


@dataclass(frozen=True)
class ModelConfig:
    arch: int
    dim: int
    hidden_dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    n_experts: int
    n_active_experts: int
    vocab_size: int
    seq_len: int
    hidden_act: int
    rope_theta: float
    dtype: torch.dtype = torch.float32
    # Q40 matmul route (ops.q40.matmul): "auto" dispatches on the device
    # (the plain version on the CPU, the kernel on the card); "plain" runs
    # the plain version on any device — the reference path a comparison
    # on the card holds the kernel against
    quant_impl: str = "auto"

    @property
    def head_size(self) -> int:
        return self.dim // self.n_heads

    @property
    def kv_dim(self) -> int:
        return self.head_size * self.n_kv_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def rope_interleaved(self) -> bool:
        """Llama uses adjacent-pair RoPE; Grok-1/Mixtral rotate-half."""
        return self.arch == mfile.ARCH_LLAMA

    @property
    def add_bos(self) -> bool:
        """Grok-1 prompts are encoded without BOS."""
        return self.arch != mfile.ARCH_GROK1

    @classmethod
    def from_spec(cls, spec: mfile.ModelSpec, dtype=torch.float32) -> "ModelConfig":
        return cls(
            arch=spec.arch, dim=spec.dim, hidden_dim=spec.hidden_dim,
            n_layers=spec.n_layers, n_heads=spec.n_heads,
            n_kv_heads=spec.n_kv_heads, n_experts=spec.n_experts,
            n_active_experts=spec.n_active_experts, vocab_size=spec.vocab_size,
            seq_len=spec.seq_len, hidden_act=spec.hidden_act,
            rope_theta=spec.rope_theta, dtype=dtype)

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


def tiny_config(arch=mfile.ARCH_LLAMA, *, dim=64, hidden_dim=96, n_layers=2,
                n_heads=4, n_kv_heads=2, n_experts=0, n_active_experts=0,
                vocab_size=128, seq_len=64, hidden_act=mfile.ACT_SILU,
                rope_theta=10000.0, dtype=torch.float32) -> ModelConfig:
    """Small config for tests."""
    return ModelConfig(arch=arch, dim=dim, hidden_dim=hidden_dim,
                       n_layers=n_layers, n_heads=n_heads, n_kv_heads=n_kv_heads,
                       n_experts=n_experts, n_active_experts=n_active_experts,
                       vocab_size=vocab_size, seq_len=seq_len,
                       hidden_act=hidden_act, rope_theta=rope_theta, dtype=dtype)
