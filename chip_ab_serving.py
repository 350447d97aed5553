"""Paired A/B of ``chip_smoke.py``'s phase 7b (or 7) on one card: the API
server at Llama-2-7B width and depth over an int8 KV pool (``--kv-quant
int8``), 8 requests on 8 slots (phase 7: a bf16 pool, 16 requests), from a
fresh server each run, so the first request pays the slot graphs'
captures.  Run from the root of a checkout:

    python3 chip_ab_serving.py --parent DIR [--order P,C,O,O,C,P] [--phase 7]

``P`` runs ``chip_smoke.serve_path`` of the checkout at ``DIR`` (an
unpacked ``git archive`` of the commit to compare with), ``C`` this
checkout's, ``O`` this checkout's with the observability calls of
``runtime/scheduler.py`` and ``runtime/engine.py`` (registry bumps, spans,
flight and timeline records) made no-ops and the scheduler's log at
WARNING.  Each run is one process; the model is synthesized once (seed 0,
as phase 7's) and deleted at the end.  Each run prints phase 7b's lines:
tok/s, TTFT, every request's latency and the graphs' capture seconds
(phase 7: one pass, without its profile and repeated bursts).
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))

CHILD = r"""
import logging, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from dllama_tpu_torch.ops import _build, attention, q40
from dllama_tpu_torch.server import api
if {off}:
    from dllama_tpu_torch.runtime import engine, scheduler

    class Off:
        def __getattr__(self, name):
            return self

        def __call__(self, *a, **k):
            return self

    scheduler.obs_metrics = scheduler.obs_flight = scheduler.obs_trace = Off()
    engine.obs_metrics = engine.obs_trace = Off()
    logging.getLogger("dllama_tpu_torch.runtime.scheduler").setLevel(logging.WARNING)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.load()
out = cs.serve_path(api, attention, q40, {m!r}, {t!r}, {n}, {extra!r}, False)
print("tok/s", out["tok_s"], "TTFT p50", out["ttft_p50"], "p99", out["ttft_p99"])
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="root of the checkout to compare with")
    ap.add_argument("--order", default="P,C,O,O,C,P")
    ap.add_argument("--phase", choices=("7", "7b"), default="7b")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from dllama_tpu_torch import quants
    from dllama_tpu_torch.io import mfile, tfile

    work = os.path.join(REPO, "build", "chip_ab_serving")
    os.makedirs(work, exist_ok=True)
    m, t = os.path.join(work, "llama2-7b.m"), os.path.join(work, "32k.t")
    trees = {"P": os.path.abspath(args.parent), "C": REPO, "O": REPO}
    rc = 0
    try:
        cs.synth_tokenizer(t, tfile)
        cs.synth_model(m, cs.LLAMA2_7B["n_layers"], mfile, quants)
        for i, v in enumerate(args.order.split(",")):
            print(f"== run {i + 1}: {v} ({trees[v]})", flush=True)
            n, extra = (16, []) if args.phase == "7" else (8, ["--kv-quant", "int8"])
            r = subprocess.run([sys.executable, "-c", CHILD.format(
                off=v == "O", m=m, t=t, n=n, extra=extra)], cwd=trees[v])
            print(f"== run {i + 1}: {v} exit {r.returncode}", flush=True)
            rc = rc or r.returncode
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
