"""Token sampler: greedy argmax / temperature / top-k / top-p (nucleus).

The host half is a copy of ``dllama_tpu/sampling.py``'s numpy sampler
(xorshift RNG included, so fixed-seed host runs reproduce the reference
stream).  :func:`sample_on_device` is the torch twin of the JAX package's
device sampler: a batched, branch-for-branch mirror of
:func:`sample_with_coin` that keeps the vocab-size logits on the device,
driven by one uniform coin per row, so a fixed coin picks the same token
on both paths.
"""

from __future__ import annotations

import numpy as np
import torch


def xorshift_u32(state: int) -> tuple[int, int]:
    """xorshift RNG step.  Returns (new_state, value)."""
    state &= 0xFFFFFFFFFFFFFFFF
    state ^= (state >> 12)
    state ^= (state << 25) & 0xFFFFFFFFFFFFFFFF
    state ^= (state >> 27)
    value = ((state * 0x2545F4914F6CDD1D) & 0xFFFFFFFFFFFFFFFF) >> 32
    return state, value


def xorshift_f32(state: int) -> tuple[int, float]:
    """Uniform [0, 1) float (top 8 bits discarded / 2^24)."""
    state, value = xorshift_u32(state)
    return state, (value >> 8) / 16777216.0


def softmax(x: np.ndarray) -> np.ndarray:
    x = x - x.max()
    e = np.exp(x)
    return e / e.sum()


def sample_mult(probs: np.ndarray, coin: float) -> int:
    """Multinomial via CDF walk."""
    cdf = np.cumsum(probs)
    idx = int(np.searchsorted(cdf, coin, side="right"))
    return min(idx, len(probs) - 1)


def sample_topp(probs: np.ndarray, topp: float, coin: float) -> int:
    """Nucleus sampling: keep candidates with p ≥ (1-topp)/(n-1), sort them
    descending (stable), truncate at cumulative > topp, then sample within
    the truncated mass."""
    n = len(probs)
    cutoff = (1.0 - topp) / (n - 1)
    idx = np.nonzero(probs >= cutoff)[0]
    if len(idx) == 0:
        # degenerate near-uniform distribution: nothing survives the cutoff
        return sample_mult(probs, coin)
    order = idx[np.argsort(-probs[idx], kind="stable")]
    p = probs[order]
    cum = np.cumsum(p)
    over = np.nonzero(cum > topp)[0]
    last = int(over[0]) if len(over) else len(order) - 1
    r = coin * cum[last]
    pick = int(np.searchsorted(cum[: last + 1], r, side="right"))
    return int(order[min(pick, last)])


def apply_topk(logits: np.ndarray, topk: int) -> np.ndarray:
    """Keep the ``topk`` largest logits (ties at the bar all survive), -inf
    the rest.  0 (or >= n) disables."""
    n = len(logits)
    if topk <= 0 or topk >= n:
        return logits
    thresh = np.partition(logits, n - topk)[n - topk]
    return np.where(logits < thresh, -np.inf, logits)


def sample_with_coin(logits: np.ndarray, coin: float, *, temperature: float,
                     topp: float, topk: int = 0,
                     mask: np.ndarray | None = None) -> int:
    """One sampling decision from an explicit uniform ``coin``: vocab mask →
    top-k filter → temperature → (greedy | nucleus | plain multinomial)."""
    logits = np.asarray(logits, dtype=np.float32).reshape(-1)
    if mask is not None:
        logits = np.where(np.asarray(mask, dtype=bool).reshape(-1),
                          logits, -np.inf)
    logits = apply_topk(logits, int(topk))
    if temperature == 0.0:
        return int(np.argmax(logits))
    probs = softmax(logits / temperature)
    if topp <= 0 or topp >= 1:
        return sample_mult(probs, coin)
    return sample_topp(probs, topp, coin)


def sample_on_device(logits: torch.Tensor, coins: torch.Tensor,
                     temps: torch.Tensor, topps: torch.Tensor,
                     topks: torch.Tensor,
                     mask: torch.Tensor | None = None) -> torch.Tensor:
    """Batched device mirror of :func:`sample_with_coin`.

    ``logits`` (B, V); ``coins``/``temps``/``topps``/``topks`` (B,) per-row
    parameters; ``mask`` an optional (V,)- or (B, V)-broadcastable boolean
    keep-mask.  Returns (B,) int32 token ids.  Descending sorts are
    ``stable`` so ties break by lower index, exactly like the host's stable
    sort (``torch.topk``'s tie order is unspecified)."""
    lf = logits.float()
    v = lf.shape[-1]
    if mask is not None:
        lf = torch.where(mask.bool(), lf, float("-inf"))
    topks = topks.to(device=lf.device, dtype=torch.int64)
    # top-k: k-th largest value as threshold, ties at the bar survive
    svals = torch.sort(lf, dim=-1, descending=True, stable=True).values
    thresh = svals.gather(-1, (topks - 1).clamp(0, v - 1)[:, None])
    lr = torch.where((topks > 0)[:, None] & (lf < thresh), float("-inf"), lf)
    greedy_tok = torch.argmax(lr, dim=-1)
    probs = torch.softmax(lr / torch.where(temps > 0, temps, 1.0)[:, None], dim=-1)
    # plain multinomial: CDF walk = searchsorted(cdf, coin, "right")
    cdf = torch.cumsum(probs, dim=-1)
    mult_tok = (cdf <= coins[:, None]).sum(-1).clamp(0, v - 1)
    # nucleus: descending probs put every p >= cutoff in a prefix
    sp, si = torch.sort(probs, dim=-1, descending=True, stable=True)
    cutoff = (1.0 - topps) / (v - 1)
    cand = sp >= cutoff[:, None]
    ncand = cand.sum(-1)
    cum = torch.cumsum(sp, dim=-1)
    over = (cum > topps[:, None]) & cand
    last = torch.where(over.any(-1), torch.argmax(over.to(torch.int32), dim=-1),
                       (ncand - 1).clamp(min=0))
    r = coins * cum.gather(-1, last[:, None])[:, 0]
    ar = torch.arange(v, device=lf.device)
    pick = ((cum <= r[:, None]) & (ar[None, :] <= last[:, None])).sum(-1)
    topp_tok = si.gather(-1, torch.minimum(pick, last)[:, None])[:, 0]
    use_topp = (topps > 0.0) & (topps < 1.0) & (ncand > 0)
    sampled = torch.where(use_topp, topp_tok, mult_tok)
    return torch.where(temps == 0.0, greedy_tok, sampled).to(torch.int32)


class Sampler:
    def __init__(self, vocab_size: int, temperature: float, topp: float,
                 seed: int, topk: int = 0):
        self.vocab_size = vocab_size
        self.temperature = temperature
        self.topp = topp
        self.topk = int(topk)
        self.rng_state = seed & 0xFFFFFFFFFFFFFFFF

    def sample(self, logits: np.ndarray, mask: np.ndarray | None = None) -> int:
        logits = np.asarray(logits, dtype=np.float32).reshape(-1)[: self.vocab_size]
        if mask is not None:
            mask = np.asarray(mask, dtype=bool).reshape(-1)[: self.vocab_size]
        if self.temperature == 0.0:
            return sample_with_coin(logits, 0.0, temperature=0.0,
                                    topp=self.topp, topk=self.topk, mask=mask)
        self.rng_state, coin = xorshift_f32(self.rng_state)
        return sample_with_coin(logits, coin, temperature=self.temperature,
                                topp=self.topp, topk=self.topk, mask=mask)
