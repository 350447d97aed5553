"""Inference engine: prefill/decode + generation loop + G/I/T stats — the
port of the batch-1 half of ``dllama_tpu/runtime/engine.py``.

Prefill pads the prompt up to a bucket (clamped to the cache) and runs it in
one forward; decode runs chunks of on-device steps
(:func:`decode_loop.decode_chunk`).  Stats keep the reference's per-token
G/I/T contract: G = whole-step wall ms, I = device compute ms, T =
device→host transfer ms.  On CUDA the engine synchronizes the device before
it reads the clock, so I and T are the device's, not the enqueue's.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve, synchronize
from ..models.config import ModelConfig
from ..models.params import Params, to_device
from ..models.transformer import forward_last, init_kv_cache
from ..sampling import Sampler
from .decode_loop import decode_chunk, device_sample


def _next_bucket(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


class ContextOverflow(ValueError):
    """The requested tokens do not fit the engine's context window."""


@dataclass
class StepStats:
    generation_ms: float = 0.0  # G: total wall time for the token
    inference_ms: float = 0.0   # I: device execution
    transfer_ms: float = 0.0    # T: device → host boundary
    sent_bytes: float = 0.0     # S: host → device (fractional per token when
    recv_bytes: float = 0.0     # R: device → host   averaged over a chunk)


@dataclass
class RunStats:
    tokens: list[StepStats] = field(default_factory=list)
    _g_sum: float = field(default=0.0, repr=False)
    _i_sum: float = field(default=0.0, repr=False)
    _t_sum: float = field(default=0.0, repr=False)
    _s_sum: float = field(default=0.0, repr=False)
    _r_sum: float = field(default=0.0, repr=False)

    def add(self, s: StepStats):
        self.tokens.append(s)
        self._g_sum += s.generation_ms
        self._i_sum += s.inference_ms
        self._t_sum += s.transfer_ms
        self._s_sum += s.sent_bytes
        self._r_sum += s.recv_bytes

    def _avg(self, total: float) -> float:
        return total / len(self.tokens) if self.tokens else 0.0

    @property
    def avg_generation_ms(self):
        return self._avg(self._g_sum)

    @property
    def avg_inference_ms(self):
        return self._avg(self._i_sum)

    @property
    def avg_transfer_ms(self):
        return self._avg(self._t_sum)

    @property
    def avg_sent_bytes(self):
        return self._avg(self._s_sum)

    @property
    def avg_recv_bytes(self):
        return self._avg(self._r_sum)

    @property
    def tokens_per_second(self):
        g = self.avg_generation_ms
        return 1000.0 / g if g > 0 else 0.0


class Engine:
    """One stream (batch 1): owns the params on the device, the KV cache,
    the position and the sampling generator.  ``device`` defaults to
    ``cuda`` (see :mod:`dllama_tpu_torch.device`)."""

    def __init__(self, cfg: ModelConfig, params: Params,
                 seq_len: int | None = None, kv_dtype=None, device=None):
        self.device = resolve(device)
        self.cfg = cfg
        self.seq_len = min(seq_len or cfg.seq_len, cfg.seq_len)
        self.params = to_device(params, self.device)
        self.cache = init_kv_cache(cfg, 1, self.seq_len, dtype=kv_dtype,
                                   device=self.device)
        self.pos = 0
        #: model forwards run (prefill passes + decode steps)
        self.forwards = 0
        #: logits (B, V) of the newest forward, left on the device
        self.last_logits: torch.Tensor | None = None
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(0)

    def reset(self):
        """Restart the sequence; cache memory is reused."""
        self.pos = 0

    def _run(self, tokens_np: np.ndarray, last_index: int) -> tuple[np.ndarray, StepStats]:
        stats = StepStats()
        t0 = time.perf_counter()
        toks = torch.from_numpy(tokens_np).to(self.device)
        logits, self.cache = forward_last(self.params, self.cfg, toks, self.cache,
                                          self.pos, last_index)
        self.forwards += 1
        self.last_logits = logits
        synchronize(self.device)
        t1 = time.perf_counter()
        host_logits = logits.cpu().numpy()  # (B, V)
        t2 = time.perf_counter()
        stats.inference_ms = (t1 - t0) * 1000
        stats.transfer_ms = (t2 - t1) * 1000
        stats.generation_ms = (t2 - t0) * 1000
        stats.sent_bytes = tokens_np.nbytes + 8  # token ids + pos/last scalars
        stats.recv_bytes = host_logits.nbytes
        return host_logits, stats

    def prefill(self, prompt_tokens: list[int]) -> tuple[np.ndarray, StepStats]:
        """Process the whole prompt; returns logits for its last token."""
        n = len(prompt_tokens)
        if n == 0:
            raise ValueError("empty prompt")
        if self.pos + n > self.seq_len:
            raise ContextOverflow(
                f"prompt of {n} exceeds seq_len {self.seq_len} at pos {self.pos}")
        # the padded bucket must also fit the cache
        bucket = max(n, min(_next_bucket(n), self.seq_len - self.pos))
        toks = np.zeros((1, bucket), np.int64)
        toks[:, :n] = prompt_tokens
        logits, stats = self._run(toks, n - 1)
        self.pos += n
        return logits, stats

    def decode_one(self, token: int) -> tuple[np.ndarray, StepStats]:
        """One autoregressive step at the current position."""
        if self.pos >= self.seq_len:
            raise ContextOverflow(f"position {self.pos} at seq_len limit {self.seq_len}")
        logits, stats = self._run(np.full((1, 1), token, np.int64), 0)
        self.pos += 1
        return logits, stats

    def generate_stream(self, prompt_tokens: list[int], steps: int, *,
                        temperature: float = 0.0, topp: float = 0.9,
                        seed: int | None = 0, eos_ids: tuple[int, ...] = (),
                        chunk: int = 16):
        """Prefill, then decode on the device in chunks; yields
        ``(token_id, StepStats)``.  Prompt tokens are echoed first; the
        per-token stats of a chunk are the chunk averages.  ``seed=None``
        continues the engine's generator instead of reseeding it.

        Chunk N+1 is enqueued (fed the on-device last token) before chunk
        N's ids are fetched, so the host's Python work overlaps the device.
        An EOS inside a chunk rewinds the position past the unconsumed
        overshoot and returns the speculative chunk's random draws."""
        steps = min(steps, self.seq_len - self.pos)
        if seed is not None:
            self._gen.manual_seed(seed)

        _, pstats = self.prefill(prompt_tokens[:])
        for i, t in enumerate(prompt_tokens):
            yield t, pstats if i == len(prompt_tokens) - 1 else StepStats()
        produced = len(prompt_tokens)
        if produced >= steps:
            return
        token = int(device_sample(self.last_logits, self._gen, temperature, topp)[0])
        yield token, StepStats()  # prefill cost already attributed above
        produced += 1
        if token in eos_ids or produced >= steps or self.pos >= self.seq_len:
            return

        def dispatch(in_tok, done):
            k = min(chunk, steps - done, self.seq_len - self.pos)
            gen_state = self._gen.get_state()
            p0 = self.pos
            sent = 8 + (in_tok.nbytes if isinstance(in_tok, np.ndarray) else 0)
            t0 = time.perf_counter()
            tok_dev = torch.as_tensor(in_tok, device=self.device)
            toks_dev, self.cache, last_dev, _, logits = decode_chunk(
                self.params, self.cfg, self.cache, tok_dev, p0, self._gen,
                steps=k, temperature=temperature, topp=topp)
            self.forwards += k
            self.last_logits = logits
            self.pos = p0 + k
            return k, p0, toks_dev, last_dev, t0, sent, gen_state

        pending = dispatch(np.full((1,), token, np.int64), produced)
        expected = produced
        boundary = None
        try:
            while pending is not None:
                k, p0, toks_dev, last_dev, t0, sent, _ = pending
                expected += k
                pending = dispatch(last_dev, expected) \
                    if expected < steps and self.pos < self.seq_len else None
                synchronize(self.device)
                t1 = time.perf_counter()
                toks = toks_dev.cpu().numpy()[:, 0]  # (k,)
                t2 = time.perf_counter()
                # steady-state chunk wall = boundary to boundary
                g0 = t0 if boundary is None else max(boundary, t0)
                boundary = t2
                per = StepStats(generation_ms=(t2 - g0) * 1000 / k,
                                inference_ms=(t1 - g0) * 1000 / k,
                                transfer_ms=(t2 - t1) * 1000 / k,
                                sent_bytes=sent / k, recv_bytes=toks.nbytes / k)
                for j, tk in enumerate(toks.tolist()):
                    token = int(tk)
                    yield token, per
                    produced += 1
                    if token in eos_ids:
                        self.pos = p0 + j + 1
                        return
                    if produced >= steps:
                        return
        finally:
            # on EOS, or a consumer that abandons the generator: the
            # in-flight chunk is dead rows past the live position; give its
            # random draws back so a later turn's stream does not depend on
            # the pipelining
            if pending is not None:
                self._gen.set_state(pending[-1])

    def generate(self, prompt_tokens: list[int], steps: int, sampler: Sampler,
                 eos_ids: tuple[int, ...] = ()):
        """Yield ``(token_id, stats)`` for up to ``steps`` tokens with the
        host sampler, one decode step per token (the reference loop)."""
        steps = min(steps, self.seq_len - self.pos)
        logits, stats = self.prefill(prompt_tokens[:])
        produced = len(prompt_tokens)
        for i, t in enumerate(prompt_tokens):
            yield t, stats if i == len(prompt_tokens) - 1 else StepStats()
        if produced >= steps:
            return
        token = int(sampler.sample(logits[0]))
        stats = StepStats()
        while True:
            yield token, stats
            produced += 1
            if produced >= steps or self.pos >= self.seq_len or token in eos_ids:
                return
            logits, stats = self.decode_one(token)
            token = int(sampler.sample(logits[0]))
