"""`dllama_tpu_torch` command line: ``inference | generate``.

The port of ``dllama_tpu/cli.py``'s single-stream modes, with the same
flags where they apply, plus ``--device {cuda,cpu}`` (default ``cuda``;
asking for ``cuda`` where there is none is an error):

* ``inference`` — benchmark mode: per-token ``G/I/T`` lines + run averages.
* ``generate``  — stream text for ``--steps`` tokens.

Both end with one line of Q40 launch counters (which matmul route ran how
often), the counterpart of the JAX package's dispatch summary.  Modes and
flags of the JAX CLI outside this slice (``chat``, ``batch``, ``worker``,
``--workers``, ``--sp``, ``--dp``, ``--pld``, ``--kv-cache-dtype q8``) exit
with a message naming them as not yet ported.

``python -m dllama_tpu_torch inference --model m.m --tokenizer t.t``
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from .device import DEVICES, resolve
from .io import mfile, tfile
from .models.config import ModelConfig
from .models.params import load_params
from .ops import q40
from .runtime.engine import Engine, RunStats
from .tokenizer.bpe import Tokenizer

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}
NOT_PORTED_MODES = ("chat", "batch", "worker")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dllama_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("mode", choices=["inference", "generate", *NOT_PORTED_MODES])
    p.add_argument("--model", help="path to .m model file")
    p.add_argument("--tokenizer", help="path to .t tokenizer file")
    p.add_argument("--prompt", default=None)
    p.add_argument("--steps", type=int, default=0)
    p.add_argument("--temperature", type=float, default=0.8)
    p.add_argument("--topp", type=float, default=0.9)
    p.add_argument("--seed", type=int, default=None, help="default: the clock")
    p.add_argument("--buffer-float-type", choices=list(DTYPES) + ["q80"], default="bf16",
                   help="compute dtype; 'q80' is accepted for reference-command "
                        "parity and maps to bf16")
    p.add_argument("--max-seq-len", type=int, default=None)
    p.add_argument("--kv-cache-dtype", choices=list(DTYPES) + ["q8"], default=None,
                   help="cache dtype (default: the compute dtype)")
    p.add_argument("--chunk", type=int, default=16, help="on-device decode chunk size")
    p.add_argument("--warmup", type=int, default=0,
                   help="inference mode: generate this many throwaway tokens "
                        "first so the timed stats measure steady state")
    p.add_argument("--device", choices=DEVICES, default="cuda",
                   help="where the model runs (default cuda)")
    # flags of the JAX CLI that this port does not carry yet
    p.add_argument("--workers", default=None, help=argparse.SUPPRESS)
    p.add_argument("--sp", type=int, default=1, help=argparse.SUPPRESS)
    p.add_argument("--dp", type=int, default=1, help=argparse.SUPPRESS)
    p.add_argument("--pld", type=int, default=0, help=argparse.SUPPRESS)
    return p


def _not_ported(args) -> list[str]:
    out = []
    if args.mode in NOT_PORTED_MODES:
        out.append(f"mode {args.mode!r}")
    if args.workers is not None:
        out.append("--workers")
    if args.sp != 1:
        out.append("--sp")
    if args.dp != 1:
        out.append("--dp")
    if args.pld:
        out.append("--pld")
    if args.kv_cache_dtype == "q8":
        out.append("--kv-cache-dtype q8")
    return out


def load_stack(args) -> tuple[Engine, Tokenizer]:
    if not args.model or not args.tokenizer:
        raise SystemExit("--model and --tokenizer are required for this mode")
    device = resolve(args.device)
    bft = args.buffer_float_type
    if bft == "q80":
        print("💡 bufferFloatType q80 → bf16 (activations stay on the device; "
              "Q80's wire compression has no wire to compress here)")
        bft = "bf16"
    with mfile.MFile(args.model) as mf:
        cfg = ModelConfig.from_spec(mf.spec, dtype=DTYPES[bft])
        print(f"💡 arch: {mf.spec.arch_name}")
        print(f"💡 dim: {cfg.dim}\n💡 nLayers: {cfg.n_layers}\n💡 nHeads: {cfg.n_heads}")
        print(f"💡 nKvHeads: {cfg.n_kv_heads}\n💡 vocabSize: {cfg.vocab_size}\n💡 seqLen: {cfg.seq_len}")
        name = torch.cuda.get_device_name(device) if device.type == "cuda" else "host"
        print(f"💡 device: {device} ({name})")
        cfg, params = load_params(mf, cfg, device=device)
    kv_dtype = DTYPES[args.kv_cache_dtype] if args.kv_cache_dtype else None
    engine = Engine(cfg, params, seq_len=args.max_seq_len, kv_dtype=kv_dtype,
                    device=device)
    tok = Tokenizer(tfile.read_tfile(args.tokenizer))
    if tok.vocab_size != cfg.vocab_size:
        raise SystemExit("tokenizer is incompatible with model (vocab size mismatch)")
    return engine, tok


def _seed(args) -> int:
    return args.seed if args.seed is not None else int(time.time())


def _encode_prompt(engine: Engine, tok: Tokenizer, prompt: str) -> list[int]:
    return tok.encode(prompt, add_bos=engine.cfg.add_bos)


def launch_line(engine: Engine) -> str:
    """End-of-run line: how often each Q40 matmul route ran, per forward."""
    c = q40.counters()
    per = c["kernel_launches"] / engine.forwards if engine.forwards else 0.0
    return (f"💡 q40 launches: kernel={c['kernel_launches']} "
            f"plain={c['plain_calls']} dense_prefill={c['dense_prefill_calls']} "
            f"forwards={engine.forwards} kernel_per_forward={per:g} "
            f"device={engine.device.type}")


def cmd_inference(args) -> Engine:
    """Benchmark mode: prints per-token G/I/T."""
    engine, tok = load_stack(args)
    ids = _encode_prompt(engine, tok, args.prompt or "Hello world")
    steps = args.steps or 64
    if args.chunk > 1:
        print(f"💡 decode runs on-device in chunks of {args.chunk}; G/I/T "
              "lines within a chunk are that chunk's per-token averages")
    if args.warmup > 0:
        t0 = time.perf_counter()
        for _ in engine.generate_stream(
                ids, len(ids) + args.warmup, temperature=args.temperature,
                topp=args.topp, seed=_seed(args), chunk=args.chunk):
            pass
        engine.reset()
        print(f"💡 warmup: {args.warmup} tokens in "
              f"{time.perf_counter() - t0:.1f}s (excluded from stats)")
    stats = RunStats()
    prev = tok.bos_id
    for token, st in engine.generate_stream(
            ids, steps + len(ids), temperature=args.temperature, topp=args.topp,
            seed=_seed(args), chunk=args.chunk):
        piece = tok.decode_piece(prev, token).decode("utf-8", errors="replace")
        prev = token
        if st.generation_ms > 0:
            stats.add(st)
        print(f"🔶 G {st.generation_ms:7.2f} ms I {st.inference_ms:7.2f} ms "
              f"T {st.transfer_ms:6.2f} ms S {st.sent_bytes / 1024:6.1f} kB "
              f"R {st.recv_bytes / 1024:6.1f} kB | {piece!r}")
    print(f"Generated tokens:    {len(stats.tokens)}")
    print(f"Avg tokens / second: {stats.tokens_per_second:.2f}")
    print(f"Avg generation time: {stats.avg_generation_ms:.2f} ms")
    print(f"Avg inference time:  {stats.avg_inference_ms:.2f} ms")
    print(f"Avg transfer time:   {stats.avg_transfer_ms:.2f} ms")
    print(f"Avg sent / recv:     {stats.avg_sent_bytes / 1024:.1f} kB / "
          f"{stats.avg_recv_bytes / 1024:.1f} kB")
    print(launch_line(engine))
    return engine


def cmd_generate(args) -> Engine:
    engine, tok = load_stack(args)
    if args.prompt is None:
        raise SystemExit("generate mode requires --prompt")
    ids = _encode_prompt(engine, tok, args.prompt)
    steps = args.steps or engine.seq_len
    prev = tok.bos_id
    eos = (tok.eos_id,) if tok.eos_id >= 0 else ()
    for token, _ in engine.generate_stream(
            ids, steps, temperature=args.temperature, topp=args.topp,
            seed=_seed(args), eos_ids=eos, chunk=args.chunk):
        sys.stdout.write(tok.decode_piece(prev, token).decode("utf-8", errors="replace"))
        sys.stdout.flush()
        prev = token
    print()
    print(launch_line(engine))
    return engine


def main(argv=None) -> Engine:
    """Run one command; returns its Engine (for callers in-process)."""
    args = build_parser().parse_args(argv)
    missing = _not_ported(args)
    if missing:
        raise SystemExit(f"not yet ported to dllama_tpu_torch: {', '.join(missing)} "
                         "(run python -m dllama_tpu for these)")
    return {"inference": cmd_inference, "generate": cmd_generate}[args.mode](args)


if __name__ == "__main__":
    main()
