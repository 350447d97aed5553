#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (dllama_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases (each prints its seconds; any failure exits non-zero):

1. card and build — the card's name and power limit from nvidia-smi, TF32
   off for matmuls and cuDNN, the Q40 kernel built with nvcc from
   ``dllama_tpu_torch/ops/csrc``.
2. kernel against its plain version at the five Llama-2-7B matmul shapes
   (wqkv, wo, w13, w2 stacked; wcls flat) for t in {1, 16, 128}, stacked
   calls at layers 0 and L-1, random packed planes from a numpy seed:
   max|kernel - plain| <= KERNEL_TOL * max|plain|.  Times the kernel, the
   plain version and torch.matmul on the pre-dequantized bf16 weight (a
   yardstick the port never calls), each launch on a cold L2.
3. the main path at full width: a Llama-2-7B-shaped Q40 model synthesized
   from a seed (random nibbles, constant f16 scale 0.008; no weights needed),
   ``inference --temperature 0 --steps 64 --chunk 16 --warmup 16`` on cuda
   through the CLI entry point; the Q40 counters must show exactly
   4 * 32 + 1 = 129 kernel launches per forward and no plain call.  Then
   torch.profiler over 8 decode steps: device busy time per token, the
   idle share, and the kernels that take the time.
4. a few requests: ``generate`` with three prompts, two greedy (each run
   twice, byte-identical) and one at temperature 0.8 seed 1; every run ends
   on finite logits.
5. kernel path against plain path end to end: the same 7B-width model cut
   to 2 layers, prefill + 8 teacher-forced decode steps; logits agree within
   E2E_TOL * max|plain| and greedy tokens agree wherever the plain top-2
   margin exceeds twice the largest logit difference.

Prints the kernel table as one JSON line before the last line; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")

# H100 SXM data-sheet peaks (dense): HBM3 rate and bf16 tensor-core rate
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
# kernel vs plain: the same exact bf16 products, summed in another order
KERNEL_TOL = 1e-3
# end to end in bf16: each matmul output rounds to bf16, so a last-bit
# difference in an f32 sum becomes a bf16 ulp (2^-8) and travels two layers
E2E_TOL = 3e-2

LLAMA2_7B = dict(dim=4096, hidden_dim=11008, n_layers=32, n_heads=32,
                 n_kv_heads=32, vocab_size=32000, seq_len=4096)
SRC = "dllama_tpu_torch/ops/csrc/q40_matmul.cu"
# (site, n, d, stacked, the TPU kernel it replaces)
SHAPES = [("wqkv", 4096, 12288, True, "dllama_tpu/ops/q40.py:449"),
          ("wo", 4096, 4096, True, "dllama_tpu/ops/q40.py:449"),
          ("w13", 4096, 22016, True, "dllama_tpu/ops/q40.py:449"),
          ("w2", 11008, 4096, True, "dllama_tpu/ops/q40.py:449"),
          ("wcls", 4096, 32000, False, "dllama_tpu/ops/q40.py:330")]
ROWS = (1, 16, 128)
STACK_L = 3


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    print(f"== {name}", flush=True)
    yield
    print(f"== {name}: {time.perf_counter() - t0:.1f} s", flush=True)


def cold_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Mean device ms of ``fn`` over ``iters`` launches, each on a cold L2
    (the decode step reads every weight once).  Before each launch the
    device spins ~1 ms while the host enqueues the flush and ``fn``, so the
    events time the device's work and not the host's enqueue; the flush
    reads 64 MB, which leaves L2 full of clean lines (a memset would leave
    dirty ones for the timed kernel to write back)."""
    fn()
    total = 0.0
    for _ in range(iters):
        torch.cuda._sleep(2_000_000)
        flush.sum()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def bound(t: int, n: int, d: int) -> tuple[float, str]:
    """Least time for the work: each input read once, the output written
    once, against the HBM rate; the multiply-adds against the bf16 peak."""
    nbytes = t * n * 2 + n * d // 2 + (n // 32) * d * 2 + t * d * 4
    b_ms, o_ms = nbytes / HBM_BYTES_S * 1e3, 2.0 * t * n * d / BF16_FLOPS * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def check_kernel(q40, dev) -> dict:
    """Phase 2; returns {site: (t=1 numbers)} for the JSON line."""
    rng = np.random.RandomState(0)
    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)
    out = {}
    print("site   t    kernel_ms  plain_ms  library_ms  bound_ms(by)      max_abs_err  rel")
    for site, n, d, stacked, replaces in SHAPES:
        np_ = q40.padded_n(n)
        lead = (STACK_L,) if stacked else ()
        qp = rng.randint(0, 256, size=(*lead, np_ // 2, d), dtype=np.uint8)
        sc = (rng.uniform(-0.02, 0.02, size=(*lead, np_ // 32, d))).astype(np.float16)
        sc[..., n // 32:, :] = 0  # pack padding: zero scales, as the loader writes
        qt = q40.QTensor(torch.from_numpy(qp).to(dev), torch.from_numpy(sc).to(dev), (n, d))
        layers = (0, STACK_L - 1) if stacked else (None,)
        w_lib = q40.dequantize(qt, torch.bfloat16, layer=layers[-1])
        for t in ROWS:
            x = torch.from_numpy(rng.randn(t, n).astype(np.float32)).to(dev, torch.bfloat16)
            err = 0.0
            for layer in layers:
                k = q40.q40_matmul(x, qt.qpacked, qt.scales, n, layer)
                p = q40.matmul_plain(x, qt, layer)
                torch.cuda.synchronize()
                e = float((k - p).abs().max())
                scale = float(p.abs().max())
                if not (torch.isfinite(k).all() and e <= KERNEL_TOL * scale):
                    raise AssertionError(f"{site} t={t} layer={layer}: max|kernel-plain| "
                                         f"{e} > {KERNEL_TOL} * {scale}")
                err = max(err, e)
            layer = layers[-1]
            k_ms = cold_ms(lambda: q40.q40_matmul(x, qt.qpacked, qt.scales, n, layer), 20, flush)
            p_ms = cold_ms(lambda: q40.matmul_plain(x, qt, layer), 5, flush)
            l_ms = cold_ms(lambda: torch.matmul(x, w_lib), 20, flush)
            b_ms, by = bound(t, n, d)
            print(f"{site:5s} {t:4d} {k_ms:10.4f} {p_ms:9.4f} {l_ms:11.4f} "
                  f"{b_ms:9.4f}({by[0]}) {err:14.6g} {err / scale:.2e}")
            if t == 1:
                out[site] = dict(replaces=replaces, max_abs_err=err, ms=k_ms,
                                 plain_ms=p_ms, bound_ms=b_ms, bound_by=by,
                                 library_ms=l_ms, n=n, d=d)
        del qt, w_lib
    del flush
    torch.cuda.empty_cache()
    return out


def synth_model(path_m: str, path_t: str, n_layers: int, mfile, tfile, quants,
                fresh: bool = False) -> None:
    """A Llama-2-7B-shaped Q40 `.m` at packed size (random nibble blocks, a
    constant small f16 scale) and a matching 32000-piece `.t`.  By default
    the nibbles tile a 4 MB random pattern (fast to write at 7B size; wcls
    rows then repeat every 2048 rows, so logits tie); ``fresh`` draws every
    byte, so the logits have no ties."""
    spec = mfile.ModelSpec(arch=mfile.ARCH_LLAMA, hidden_act=mfile.ACT_SILU,
                           rope_theta=10000.0, weights_ftype=quants.Q40,
                           **{**LLAMA2_7B, "n_layers": n_layers})
    rng = np.random.RandomState(0)
    scale = np.frombuffer(np.float16(0.008).tobytes(), np.uint8)
    nib_pool = rng.randint(0, 256, 1 << 22, dtype=np.uint8)
    with mfile.MFileWriter(path_m, spec) as w:
        for info in w.plan:
            n = int(np.prod(info.shape))
            if info.ftype == quants.Q40:
                arr = np.empty((n // 32, quants.Q40_BLOCK_BYTES), np.uint8)
                arr[:, :2] = scale
                arr[:, 2:] = (rng.randint(0, 256, (n // 32, 16), dtype=np.uint8) if fresh
                              else np.resize(nib_pool, (n // 32, 16)))
                w.write_raw(info.name, arr)
            else:
                w.write_tensor(info.name,
                               (rng.randn(*info.shape) * 0.02).astype(np.float32)
                               if info.name == "token_embedding"
                               else np.ones(info.shape, np.float32))
    words = [b" ", b"a", b"e", b"o", b"t", b"he", b"the", b" the", b"on", b"ce",
             b" upon", b" time", b"Once", b" capital", b" of", b" France", b" is"]
    vocab = [b"<unk>", b"<s>", b"</s>"] + [f"<0x{i:02X}>".encode() for i in range(256)]
    vocab += words
    vocab += [f"<extra_{i}>".encode() for i in range(len(vocab), LLAMA2_7B["vocab_size"])]
    tfile.write_tfile(path_t, tfile.TokenizerData(
        vocab=vocab, scores=[float(len(v)) if v in words else 0.0 for v in vocab],
        bos_id=1, eos_id=2))


def run_cli(cli, argv: list[str]):
    """One CLI command in-process; returns (engine, captured stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        engine = cli.main(argv)
    torch.cuda.synchronize()
    return engine, buf.getvalue()


def main_path(cli, q40, m: str, t: str) -> dict:
    """Phase 3; returns the run's numbers."""
    torch.cuda.reset_peak_memory_stats()
    q40.reset_counters()
    engine, out = run_cli(cli, ["inference", "--model", m, "--tokenizer", t,
                                "--temperature", "0", "--steps", "64",
                                "--chunk", "16", "--warmup", "16"])
    c = q40.counters()
    peak = torch.cuda.max_memory_allocated()
    print("\n".join(out.splitlines()[-8:]))
    per_fwd = 4 * LLAMA2_7B["n_layers"] + 1
    if c["kernel_launches"] != per_fwd * engine.forwards or c["plain_calls"] \
            or c["dense_prefill_calls"]:
        raise AssertionError(f"main path did not run every matmul through the "
                             f"kernel: {c} over {engine.forwards} forwards")
    tps = float(re.search(r"Avg tokens / second: ([\d.]+)", out).group(1))
    ms = float(re.search(r"Avg generation time: ([\d.]+) ms", out).group(1))
    if not torch.isfinite(engine.last_logits).all():
        raise AssertionError("main path ended on non-finite logits")
    print(f"main path: {tps} tok/s, {ms} ms/token, peak device memory "
          f"{peak / 2**30:.2f} GiB, {engine.forwards} forwards, "
          f"{c['kernel_launches']} kernel launches ({per_fwd} per forward)")
    profile_decode(engine, ms)
    del engine
    torch.cuda.empty_cache()
    return dict(counts=c, tok_s=tps, ms_token=ms, peak_bytes=peak)


def profile_decode(engine, ms_token: float, steps: int = 8) -> None:
    """Where a decode token's time goes: torch.profiler over ``steps``
    greedy decode steps of the main path's engine.  Device busy time per
    token is the sum of the kernels' device times; the idle share compares
    it with the unprofiled ms/token of the run above."""
    from torch.profiler import ProfilerActivity, profile
    from dllama_tpu_torch.runtime.decode_loop import decode_chunk

    engine.reset()
    engine.prefill([1, 2, 3, 4])
    tok = torch.tensor([4], device=engine.device)
    gen = torch.Generator(device=engine.device)  # greedy: never drawn from
    run = lambda: decode_chunk(engine.params, engine.cfg, engine.cache, tok,  # noqa: E731
                               engine.pos, gen, steps=steps, temperature=0.0,
                               topp=0.9)
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((us / steps / 1e3, e.count // steps, e.key))
    if not rows:
        print("decode profile: the profiler recorded no device time (not measured)")
        return
    busy = sum(r[0] for r in rows)
    q40_ms = sum(r[0] for r in rows if "q40_" in r[2])
    print(f"decode profile ({steps} steps): device busy {busy:.3f} ms/token of "
          f"{ms_token} ms/token unprofiled -> idle share {1 - busy / ms_token:.3f}; "
          f"q40 kernels {q40_ms:.3f} ms/token, other kernels {busy - q40_ms:.3f} "
          f"ms/token, {sum(r[1] for r in rows)} kernel launches/token")
    for ms_, n, name in sorted(rows, reverse=True)[:10]:
        print(f"  {ms_:8.4f} ms/token {n:5d}x  {name[:90]}")


def requests(cli, q40, m: str, t: str) -> None:
    """Phase 4."""
    base = ["generate", "--model", m, "--tokenizer", t, "--steps", "40"]
    runs = [("Once upon a time", ["--temperature", "0"], 2),
            ("The capital of France is", ["--temperature", "0"], 2),
            ("hello", ["--temperature", "0.8", "--seed", "1"], 1)]
    for prompt, extra, repeats in runs:
        outs = []
        for _ in range(repeats):
            q40.reset_counters()
            engine, out = run_cli(cli, base + ["--prompt", prompt] + extra)
            if not torch.isfinite(engine.last_logits).all():
                raise AssertionError(f"{prompt!r}: non-finite logits")
            outs.append(out)
            del engine
        if len(set(outs)) != 1:
            raise AssertionError(f"greedy {prompt!r} differs between two runs")
        text = [ln for ln in outs[0].splitlines() if not ln.startswith("💡")]
        print(f"{prompt!r} {' '.join(extra)}: {len(text[0])} chars"
              + (", repeats byte for byte" if repeats > 1 else ""))
    torch.cuda.empty_cache()


def end_to_end(mfile, params_mod, transformer, config, m2: str, dev) -> None:
    """Phase 5."""
    with mfile.MFile(m2) as mf:
        cfg, params = params_mod.load_params(
            mf, config.ModelConfig.from_spec(mf.spec, dtype=torch.bfloat16), device=dev)
    rng = np.random.RandomState(1)
    prompt = torch.from_numpy(rng.randint(3, cfg.vocab_size, (1, 12))).to(dev)
    forced = rng.randint(3, cfg.vocab_size, 8).tolist()
    logits = {}
    for impl in ("auto", "plain"):
        c = cfg.with_(quant_impl=impl)
        cache = transformer.init_kv_cache(c, 1, device=dev)
        steps = [transformer.forward_last(params, c, prompt, cache, 0, 11)[0]]
        for i, tok in enumerate(forced):
            x = torch.tensor([[tok]], device=dev)
            steps.append(transformer.forward_last(params, c, x, cache, 12 + i, 0)[0])
        logits[impl] = torch.stack(steps).float()
    k, p = logits["auto"], logits["plain"]
    err, scale = float((k - p).abs().max()), float(p.abs().max())
    if not (torch.isfinite(k).all() and err <= E2E_TOL * scale):
        raise AssertionError(f"kernel vs plain logits: {err} > {E2E_TOL} * {scale}")
    # a top-2 margin above twice the largest logit difference cannot flip
    # the argmax: there the greedy tokens must agree
    top2 = p.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * err
    agree = k.argmax(-1) == p.argmax(-1)
    if not bool(agree[decided].all()):
        raise AssertionError("greedy tokens differ where the margin is decisive")
    print(f"end to end (2 layers, bf16): max|kernel-plain| {err:.4g} of max|plain| "
          f"{scale:.4g} ({err / scale:.2e}, limit {E2E_TOL:g}); greedy agrees at "
          f"{int(decided.sum())}/9 steps whose top-2 margin exceeds 2x that "
          f"({int(agree.sum())}/9 overall)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from dllama_tpu_torch import cli, quants
    from dllama_tpu_torch.io import mfile, tfile
    from dllama_tpu_torch.models import config, params as params_mod, transformer
    from dllama_tpu_torch.ops import _build, q40

    dev = torch.device("cuda", 0)
    with phase("1 card and build"):
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, check=True).stdout.strip().splitlines()[0]
        print(card)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = "
              "torch.backends.cudnn.allow_tf32 = False")
        print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
              f"{torch.cuda.get_device_name(0)}")
        _build.load()
        print(_build.build_log.strip() or f"kernel library {_build.library_path()}")
    with phase("2 kernel vs plain at the 7B shapes"):
        table = check_kernel(q40, dev)
    os.makedirs(WORK, exist_ok=True)
    try:
        m, t, m2 = (os.path.join(WORK, f) for f in ("llama2-7b.m", "llama2-7b.t", "l2.m"))
        with phase("3 main path: inference at Llama-2-7B width"):
            synth_model(m, t, LLAMA2_7B["n_layers"], mfile, tfile, quants)
            print(f"synthesized {os.path.getsize(m) / 1e9:.2f} GB")
            run = main_path(cli, q40, m, t)
        with phase("4 requests: generate"):
            requests(cli, q40, m, t)
        with phase("5 kernel path vs plain path end to end"):
            synth_model(m2, t, 2, mfile, tfile, quants, fresh=True)
            end_to_end(mfile, params_mod, transformer, config, m2, dev)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    counts = run["counts"]["launches_by_shape"]
    kernels = [dict(name=f"q40_matmul[{site}]", route="cuda", source=SRC,
                    replaces=r["replaces"], launches=counts.get((r["n"], r["d"]), 0),
                    max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    library_ms=r["library_ms"])
               for site, r in table.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
