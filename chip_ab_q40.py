#!/usr/bin/env python3
"""Time the tensor-core body of the Q40 or Q80 kernel of two trees on one
card, in turns.

    git archive <parent> | tar -x -C build/parent
    python3 chip_ab_q40.py --parent build/parent [--order P,C,C,P] [--codec q8]

Each run is a child process that imports ``dllama_tpu_torch`` from its
tree (P the parent's, C this checkout's), builds that tree's kernels, and
times the codec's kernel with ``body="mma"`` (the tensor-core body,
classic numerics) at the five Llama-2-7B sites: the stacked wqkv, wo, w13
and w2 (plane 2 of 3) at t = 16 and 128, wcls at t = 16, 128, 512 and
4096 (Q80: 16, 128 and 512), and for Q40 kernel 3 in its default tiles at
the stacked sites, t = 16 and 128.  Each time is ``chip_smoke.cold_ms``'s
median of 20 launches on a cold L2, on the same random planes (seed 0) in
every run.  C's runs also time ``torch.matmul`` on the dequantized bf16
weight (a yardstick the port never calls) and print each shape's bound.
Prints the card's name and power limit, each run's times, and for each
shape the median of P's runs, of C's runs and their ratio.

    python3 chip_ab_q40.py --plans [--codec q8]

times this checkout's body alone under other grids than the codec's
``mma_plan`` (each tile height the call may take, and split counts around
the plan's) at the same shapes and the 7B sites at t = 512: the
measurements the plan's ``MMA_STEP_US`` is set from.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
SITES = [("wqkv", 4096, 12288, (3,)), ("wo", 4096, 4096, (3,)),
         ("w13", 4096, 22016, (3,)), ("w2", 11008, 4096, (3,)), ("wcls", 4096, 32000, ())]
ROWS = {"q40": {"wcls": (16, 128, 512, 4096)}, "q8": {"wcls": (16, 128, 512)}}
STACK_ROWS = (16, 128)


def _codec(name: str):
    """The codec module, its kernel wrapper and its bytes a weight."""
    from dllama_tpu_torch.ops import q8, q40
    return (q8, q8.q8_matmul, 1.0) if name == "q8" else (q40, q40.q40_matmul, 0.5)


def child(tree: str, library: bool, codec_name: str) -> int:
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from dllama_tpu_torch.ops import _build, q40
    codec, kernel, value_bytes = _codec(codec_name)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)
    cs.warm_clocks(dev)
    out = {}
    for site, n, d, lead in SITES:
        qt = cs.random_planes(codec, lead, n, d, g, dev)
        layer = lead[0] - 1 if lead else None
        bqt = q40.to_blocked(qt) if lead and codec is q40 else None
        w_lib = codec.dequantize(qt, torch.bfloat16, layer=layer) if library else None
        for t in ROWS[codec_name].get(site, STACK_ROWS):
            x = torch.randn((t, n), generator=g, device=dev).to(torch.bfloat16)
            out[f"{site},t={t}"] = cs.cold_ms(
                lambda: kernel(x, qt.qpacked, qt.scales, n, layer, body="mma"), 20, flush)
            if bqt is not None:
                out[f"k3.{site},t={t}"] = cs.cold_ms(
                    lambda: q40.q40_blocked_matmul(x, bqt.qpacked, bqt.scales, (n, d), layer,
                                                   body="mma"), 20, flush)
            if library:
                out[f"library.{site},t={t}"] = cs.cold_ms(lambda: torch.matmul(x, w_lib), 20,
                                                          flush)
                out[f"bound.{site},t={t}"] = cs.bound(t, n, d, value_bytes)[0]
        del qt, bqt, w_lib
    print(json.dumps({"times": out}), flush=True)
    return 0


def plans(codec_name: str) -> int:
    """``--plans``: each shape under each (bm, splits) candidate."""
    sys.path.insert(0, REPO)
    import torch
    import chip_smoke as cs
    from dllama_tpu_torch.ops import _build, q40
    codec, kernel, _ = _codec(codec_name)
    _build.load()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)
    cs.warm_clocks(dev)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    planned = codec.mma_plan
    print(f"{codec_name}: shape          plan (bm, splits)  ms        "
          f"[candidates: bm/splits ms]")
    for site, n, d, lead in SITES:
        qt = cs.random_planes(codec, lead, n, d, g, dev)
        layer = lead[0] - 1 if lead else None
        for t in ROWS[codec_name].get(site, STACK_ROWS + (512,)):
            x = torch.randn((t, n), generator=g, device=dev).to(torch.bfloat16)
            steps = -(-n // q40.MMA_BK)
            own = planned(t, n, d, n_sms)
            got = {}
            for bm in [b for b in codec.MMA_BMS if t <= 2 * b <= 8 * t or b == own.bm]:
                tiles = -(-t // bm) * -(-d // q40.MMA_BN)
                for splits in sorted({1, 2, 3, 4, 6, 8, own.splits}):
                    per = -(-steps // splits)
                    if -(-steps // per) != splits or splits > 1 and (
                            splits * t * d * 4 > 256 << 20 or tiles * splits > 4 * n_sms):
                        continue
                    codec.mma_plan = lambda *a, **k: q40.MmaPlan(bm, q40.MMA_BN, splits, per)  # noqa
                    try:
                        got[(bm, splits)] = cs.cold_ms(
                            lambda: kernel(x, qt.qpacked, qt.scales, n, layer, body="mma"),
                            20, flush)
                    finally:
                        codec.mma_plan = planned
            best = min(got, key=got.get)
            print(f"{site + ',t=' + str(t):18s} {str((own.bm, own.splits)):18s} "
                  f"{got.get((own.bm, own.splits), float('nan')):8.4f}  best {best} "
                  f"{got[best]:.4f}  [" + ", ".join(f"{b}/{s_} {ms:.4f}"
                                                   for (b, s_), ms in sorted(got.items()))
                  + "]", flush=True)
        del qt
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="the parent tree (a git archive)")
    ap.add_argument("--order", default="P,C,C,P")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--library", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--plans", action="store_true", help="time other grids than the plan's")
    ap.add_argument("--codec", default="q40", choices=("q40", "q8"))
    a = ap.parse_args()
    if a.plans:
        return plans(a.codec)
    if a.child:
        return child(a.child, a.library, a.codec)
    import torch
    if not torch.cuda.is_available():
        print("chip_ab_q40: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    trees = {"P": a.parent, "C": REPO}
    runs = []
    for i, who in enumerate(a.order.split(",")):
        lib = who == "C" and not any(w == "C" for w, _ in runs)
        r = subprocess.run([sys.executable, __file__, "--child", trees[who], "--codec", a.codec]
                           + (["--library"] if lib else []), capture_output=True, text=True,
                           timeout=1200)
        if r.returncode != 0:
            print(r.stdout[-4000:], r.stderr[-8000:], file=sys.stderr)
            raise SystemExit(f"run {i} ({who}) failed: exit {r.returncode}")
        times = json.loads(r.stdout.strip().splitlines()[-1])["times"]
        print(f"run {i} {who}: " + json.dumps(times), flush=True)
        runs.append((who, times))
    import statistics
    keys = [k for k in runs[0][1] if "." not in k.split(",")[0] or k.startswith("k3.")]
    ref = next(t for w, t in runs if w == "C" and any(k.startswith("library.") for k in t))
    print("shape               P_ms      C_ms      C/P     library_ms  bound_ms")
    for k in keys:
        p = statistics.median(t[k] for w, t in runs if w == "P")
        c = statistics.median(t[k] for w, t in runs if w == "C")
        base = k[3:] if k.startswith("k3.") else k
        lib_ms, b_ms = ref.get(f"library.{base}"), ref.get(f"bound.{base}")
        print(f"{k:18s} {p:9.4f} {c:9.4f} {c / p:7.3f}   {lib_ms:10.4f} {b_ms:9.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
