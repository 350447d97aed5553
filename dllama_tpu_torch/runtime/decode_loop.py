"""Device-side generation loop: K decode steps + sampling, only token ids
cross to the host — the port of ``dllama_tpu/runtime/decode_loop.py``
(``decode_chunk`` for one stream, ``slot_chunk`` for the slot batch).

The steps run as a Python loop of eager forwards; the sampled token stays a
device tensor that feeds the next step's embedding lookup, so a chunk is
enqueued without a host round trip.  On ``cuda`` at tp = 1 the engine
replays each pure-decode step as a captured CUDA graph instead
(``runtime.graphs``, whose step bodies are held to these functions).  Greedy (temperature 0) is the exact
argmax; temperature/top-k/top-p run :func:`sampling.sample_on_device` with
one uniform coin per row drawn from an explicit ``torch.Generator`` on the
device.  The coin stream is not the JAX package's threefry stream, so only
greedy streams are held equal to it.
"""

from __future__ import annotations

import torch

from ..models.config import ModelConfig
from ..models.transformer import KVCache, forward_last, forward_slots
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
                 temperature: float, topp: float,
                 offsets: torch.Tensor | None = None):
    """Generate ``steps`` tokens from ``token`` (B,) at ``pos``; every row
    samples its own next token.  ``offsets`` (B,) is a ragged batch's left
    padding (per-row RoPE positions and key floors, see
    ``transformer.run_blocks``).  Returns (tokens (steps, B), cache,
    last_token, new_pos, last_logits)."""
    toks = []
    logits = None
    for i in range(steps):
        logits, cache = forward_last(params, cfg, token[:, None], cache, pos + i, 0,
                                     offsets=offsets)
        token = device_sample(logits, generator, temperature, topp)
        toks.append(token)
    return torch.stack(toks), cache, token, pos + steps, logits


def device_sample_rows(logits: torch.Tensor, generator: torch.Generator,
                       temps: torch.Tensor, topps: torch.Tensor, greedy: bool,
                       topks: torch.Tensor | None = None) -> torch.Tensor:
    """Per-row sampling (B, V) → (B,) int32 for slot rows that belong to
    different requests: temperature/top-p/top-k arrive as (B,) tensors.
    ``greedy`` (every row at temperature 0) is the argmax alone and draws
    no coin; otherwise one uniform coin per row comes from ``generator``
    and rows at temperature 0 still take the exact argmax."""
    if greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    b = logits.shape[0]
    coins = torch.rand((b,), generator=generator, device=logits.device,
                       dtype=torch.float32)
    if topks is None:
        topks = torch.zeros((b,), dtype=torch.int32, device=logits.device)
    return sample_on_device(logits, coins, temps, topps, topks)


def slot_chunk(params, cfg: ModelConfig, cache: KVCache, tokens: torch.Tensor,
               pos_rows: torch.Tensor, n_valid: torch.Tensor,
               generator: torch.Generator, temps: torch.Tensor,
               topps: torch.Tensor, topks: torch.Tensor | None = None, *,
               steps: int, greedy: bool, page_table: torch.Tensor | None = None):
    """One continuous-batching dispatch: a mixed prefill/decode forward over
    (B, T) slot rows, then ``steps - 1`` pure decode steps, each row fed
    its own previous sample on the device.  Row ``r`` consumes its first
    ``n_valid[r]`` tokens at ``pos_rows[r]..``.  Returns (tokens (steps, B)
    int32, cache, last (B,), last logits (B, V)); ``last`` is the final
    sampled row, left on the device for the next dispatch to consume.  The
    caller advances the slot clocks host-side."""
    logits, cache = forward_slots(params, cfg, tokens, cache, pos_rows, n_valid,
                                  page_table=page_table)
    tok = device_sample_rows(logits, generator, temps, topps, greedy, topks)
    toks = [tok]
    pos_rows = pos_rows + n_valid
    ones = torch.ones_like(pos_rows)
    for _ in range(steps - 1):
        logits, cache = forward_slots(params, cfg, tok[:, None], cache, pos_rows,
                                      ones, page_table=page_table)
        tok = device_sample_rows(logits, generator, temps, topps, greedy, topks)
        toks.append(tok)
        pos_rows = pos_rows + 1
    return torch.stack(toks), cache, tok, logits
