"""Kernel 8's rounding against an f64 reference, over repeated draws of
scratch page 0 (needs one CUDA card).

Phase 6c of ``chip_smoke.py`` writes each step's K/V as the slot step
writes it: the tokens that land on scratch page 0 collide, and which write
wins is unordered, so page 0's 16 keys differ from run to run, and row 5
(whose table runs out into page 0 at position 640) reads them about a
hundred times at T = 256.  This script repeats 6c's 7B-shape passes (bf16
and int8 pools, every width) ``--repeats`` times and prints, for each pass,
the worst query row's max|a - b| / max|b| of kernel vs plain (what 6c holds
to 1e-2), kernel vs f64 and plain vs f64 (the f64 reference computes the
softmax and PV without rounding the probabilities), then the maxima over
the repeats for each codec and width.  It checks nothing and times nothing.

    python3 chip_prefill_rounding.py [--repeats 25]
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys

import torch

import chip_smoke as cs

RECORDS: list[dict] = []


def f64_reference(attention, q, pk, pv, layer, table, pos, scales) -> torch.Tensor:
    """Causal GQA at G = 1 over the gathered view in f64: q and K/V as the
    plain version's operands (q rounded to the operand type, int8 values
    dequantized and rounded to bf16), the probabilities unrounded."""
    op = torch.bfloat16 if scales is not None else pk.dtype
    ks, vs = scales if scales is not None else (None, None)
    k = attention.paged_gather_layer(pk, layer, table, ks).to(op).double()
    v = attention.paged_gather_layer(pv, layer, table, vs).to(op).double()
    t, dh = q.shape[2], q.shape[3]
    s = torch.einsum("bhtd,bhsd->bhts", q.to(op).double(), k) / math.sqrt(dh)
    s_idx = torch.arange(k.shape[2], device=q.device)[None, None, :]
    t_idx = pos.long()[:, None, None] + torch.arange(t, device=q.device)[None, :, None]
    s = s.masked_fill(~(s_idx <= t_idx)[:, None], float("-inf"))
    return torch.einsum("bhts,bhsd->bhtd", torch.softmax(s, -1), v)


def record(attention, args, tol, label, pos_np, head_max=False):
    """Stands in for ``chip_smoke._prefill_rows_agree``: records the three
    errors of the pass instead of raising, and returns what 6c prints."""
    q, rest = args[0], args[1:]
    kern = attention.prefill_attention(q.float(), *rest).double()
    plain = attention.paged_rows_attention(q.float(), *rest).double()
    exact = f64_reference(attention, q, *rest)

    def rel(a, b):
        return (a - b).abs().amax(-1) / b.abs().amax(-1).clamp_min(1e-300)

    kp = rel(kern, plain)
    RECORDS.append(dict(label=label, kernel_plain=float(kp.max()),
                        kernel_f64=float(rel(kern, exact).max()),
                        plain_f64=float(rel(plain, exact).max()),
                        over_tol=bool((kp > tol).any())))
    print(json.dumps(RECORDS[-1]), flush=True)
    diff = (kern - plain).abs().amax(-1)
    return float(diff.max()), float(plain.abs().amax()), kp.float(), kp.float()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=25)
    repeats = ap.parse_args().repeats
    if not torch.cuda.is_available():
        print("chip_prefill_rounding.py needs a CUDA card", file=sys.stderr)
        return 1
    from dllama_tpu_torch.ops import _build, attention
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    cs._prefill_rows_agree = record
    cs.cold_ms = lambda fn, iters, flush: float("nan")
    dev = torch.device("cuda", 0)
    for _ in range(repeats):
        cs.check_prefill_attention(attention, dev, cs.LLAMA2_7B["n_kv_heads"], ("bf16", "int8"))
        torch.cuda.empty_cache()
    print("codec    t  passes  over_tol  max kernel-plain  max kernel-f64  max plain-f64")
    for codec in ("bf16", "int8"):
        for t in cs.PREFILL_T + cs.PREFILL_T_WIDE[1]:
            rs = [r for r in RECORDS if f" {codec} t={t} " in r["label"]]
            print(f"{codec:5s} {t:4d} {len(rs):7d} {sum(r['over_tol'] for r in rs):9d} "
                  f"{max(r['kernel_plain'] for r in rs):17.3e} "
                  f"{max(r['kernel_f64'] for r in rs):14.3e} "
                  f"{max(r['plain_f64'] for r in rs):14.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
