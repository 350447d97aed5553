"""Device-side generation loop: K decode steps + sampling, only token ids
cross to the host — the port of ``dllama_tpu/runtime/decode_loop.py``.

The steps run as a Python loop of eager forwards; the sampled token stays a
device tensor that feeds the next step's embedding lookup, so a chunk is
enqueued without a host round trip.  Greedy (temperature 0) is the exact
argmax; temperature/top-k/top-p run :func:`sampling.sample_on_device` with
one uniform coin per row drawn from an explicit ``torch.Generator`` on the
device.  The coin stream is not the JAX package's threefry stream, so only
greedy streams are held equal to it.
"""

from __future__ import annotations

import torch

from ..models.config import ModelConfig
from ..models.transformer import KVCache, forward_last
from ..sampling import sample_on_device


def device_sample(logits: torch.Tensor, generator: torch.Generator,
                  temperature: float, topp: float) -> torch.Tensor:
    """Token ids (B,) int32 from logits (B, V) on their device."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    b, dev = logits.shape[0], logits.device
    coins = torch.rand((b,), generator=generator, device=dev, dtype=torch.float32)

    def full(v, dt):
        return torch.full((b,), v, dtype=dt, device=dev)

    return sample_on_device(logits, coins, full(temperature, torch.float32),
                            full(topp, torch.float32), full(0, torch.int32))


def decode_chunk(params, cfg: ModelConfig, cache: KVCache, token: torch.Tensor,
                 pos: int, generator: torch.Generator, *, steps: int,
                 temperature: float, topp: float):
    """Generate ``steps`` tokens from ``token`` (B,) at ``pos``.  Returns
    (tokens (steps, B), cache, last_token, new_pos, last_logits)."""
    toks = []
    logits = None
    for i in range(steps):
        logits, cache = forward_last(params, cfg, token[:, None], cache, pos + i, 0)
        token = device_sample(logits, generator, temperature, topp)
        toks.append(token)
    return torch.stack(toks), cache, token, pos + steps, logits
