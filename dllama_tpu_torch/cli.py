"""`dllama_tpu_torch` command line: ``inference | generate | chat | batch``.

The port of ``dllama_tpu/cli.py``'s single-host modes, with the same
flags where they apply, plus ``--device {cuda,cpu}`` (default ``cuda``;
asking for ``cuda`` where there is none is an error):

* ``inference`` — benchmark mode: per-token ``G/I/T`` lines + run averages.
* ``generate``  — stream text for ``--steps`` tokens.
* ``chat``      — multi-turn REPL on stdin, one KV cache a conversation.
* ``batch``     — the prompts of ``--prompts-file`` (one a line) decoded
  as one lockstep ragged batch.

Each ends with one line of launch counters of the model's matmul codec
(Q40 or Q80: which route ran how often, and the layout; with tensor
parallelism the all-reduce's too), the counterpart of the JAX package's
dispatch summary.  ``DLLAMA_Q40_LAYOUT=blocked`` loads Q40 weights in the
tile-contiguous layout (kernel 3).  ``--workers tpu:N`` slices the model
over N tensor-parallel ranks (``parallel/mesh.py``): with ``--device
cpu`` every rank on the CPU, with ``cuda:K`` every rank on card K, with
``cuda`` rank r on card r.  The API server (``python -m
dllama_tpu_torch.server.api``) reuses this parser and its serving flags.
``--kv-cache-dtype q8`` keeps the KV cache in int8 with per-position
scales.  ``--pld K`` (``inference``, ``generate``; greedy) decodes with
prompt-lookup speculation (``Engine.generate_pld_stream``); ``--spec
pld|draft`` (with ``--spec-k`` and ``--draft-model``) arms the server's
slot scheduler with a proposer (``runtime/spec.py``); ``inference
--profile-split`` / ``--profile-ops`` trace a few decode steps under
``torch.profiler`` after the run (``runtime/profiling.py``).  Modes and
flags of the JAX CLI outside the port (``worker``, ``--sp``, ``--dp``,
``--ep``, and the flags in ``NOT_PORTED_FLAGS``) exit with a message naming
them as not yet ported.

``python -m dllama_tpu_torch inference --model m.m --tokenizer t.t``
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from .device import DEVICES, resolve
from .io import mfile, tfile
from .models.config import ModelConfig
from .models.params import load_params
from .ops import q8, q40
from .parallel.mesh import parse_workers
from .parallel.sharding import check_tp_constraint
from .runtime.engine import Engine, RunStats
from .runtime.stream import drain_generation
from .tokenizer.bpe import Tokenizer
from .tokenizer.chat import ChatItem, ChatTemplate, TokenizerChatStops
from .tokenizer.eos import EosDetector

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}
MODES = ("inference", "generate", "chat", "batch")
NOT_PORTED_MODES = ("worker", "router", "serve-pod")
# flags of the JAX CLI that the port does not carry, with the JAX defaults:
# a value other than the default exits naming the flag
NOT_PORTED_FLAGS = {
    # multi-host and weight loading
    "--weights-float-type": None, "--dequantize": False,
    "--coordinator": None, "--nproc": None,
    "--proc-id": None, "--program": "generate",
    # the fleet router, the pod supervisor and the elastic pod
    "--backends": None, "--probe-interval": 2.0, "--eject-after": 3,
    "--readmit-after": 2, "--router-retries": 2, "--upstream-timeout": 120.0,
    "--stall-timeout": 0.0, "--checkpoint-interval": 0.0, "--resume-policy": "auto",
    "--supervise": False, "--respawn-max": 5, "--respawn-window": 30.0,
    "--elastic": False, "--pod-devices": 0, "--min-replicas": 1, "--max-replicas": 0,
    "--elastic-interval": 2.0, "--elastic-window": 5, "--elastic-cooldown": 30.0,
    "--scale-up-util": 0.85, "--scale-down-util": 0.15, "--scale-up-queue": 2.0,
    "--reshape-kv-low": 0.08,
    # serving
    "--io-timeout": 15.0, "--drain-grace": 30.0, "--step-timeout": None,
    "--numeric-checks": False, "--verify-weights": False,
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dllama_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("mode", choices=[*MODES, *NOT_PORTED_MODES])
    p.add_argument("--model", help="path to .m model file")
    p.add_argument("--tokenizer", help="path to .t tokenizer file")
    p.add_argument("--prompt", default=None)
    p.add_argument("--prompts-file", default=None,
                   help="batch mode: one prompt per line, decoded as one "
                        "lockstep ragged batch")
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
    p.add_argument("--pld", type=int, default=0, metavar="K",
                   help="inference and generate modes, temperature 0: prompt-lookup "
                        "speculative decoding — propose K tokens from the latest "
                        "matching n-gram in the context and verify them in one "
                        "forward (a valid greedy stream; on the card the window's "
                        "matmuls take the tensor-core body, so an argmax near-tie "
                        "can resolve otherwise than in single-token decode)")
    p.add_argument("--profile-split", action="store_true",
                   help="inference mode: after the run, trace a few decode steps "
                        "with torch.profiler and report compute against collective "
                        "time (kernel 4, the reference's I/T split)")
    p.add_argument("--profile-ops", action="store_true",
                   help="inference mode: like --profile-split, and list the top "
                        "kernels by device time")
    p.add_argument("--device", default="cuda",
                   help=f"where the model runs: one of {', '.join(DEVICES)}, or "
                        "cuda:K (default cuda)")
    p.add_argument("--workers", default=None,
                   help="tpu:N — N-way tensor parallelism (the JAX CLI's spelling): "
                        "every rank on the CPU with --device cpu, on card K with "
                        "cuda:K, rank r on card r with cuda")
    # serving (python -m dllama_tpu_torch.server.api), the JAX defaults
    p.add_argument("--host", default="0.0.0.0", help="API server bind address")
    p.add_argument("--port", type=int, default=9990, help="API server port")
    p.add_argument("--batch-slots", type=int, default=0,
                   help="API server: slots of the continuous-batching engine "
                        "(0: every request takes the batch-1 mutex path)")
    p.add_argument("--kv-pages", type=int, default=0,
                   help="API server: paged KV pool of this many pages for the "
                        "slot engine (0: contiguous slot rows)")
    p.add_argument("--kv-page-size", type=int, default=16, help="tokens per KV page")
    p.add_argument("--kv-quant", choices=("off", "int8"), default="off",
                   help="int8 pool pages with per-position scales (needs --kv-pages)")
    p.add_argument("--sched-prefill-chunk", type=int, default=16,
                   help="prompt tokens a prefilling slot feeds per dispatch")
    p.add_argument("--sched-max-wait-ms", type=float, default=50.0,
                   help="bound on how long queued work waits for a decode burst")
    p.add_argument("--sched-max-queue", type=int, default=32,
                   help="requests waiting for a slot before 429")
    p.add_argument("--no-prefix-reuse", action="store_true",
                   help="turn off the paged pool's radix prefix cache")
    p.add_argument("--spec", choices=("off", "pld", "draft"), default="off",
                   help="slot scheduler: per-slot speculative decoding "
                        "(runtime/spec.py).  'pld' drafts from a per-slot prompt-lookup "
                        "n-gram index, 'draft' from a second smaller model "
                        "(--draft-model).  Greedy output stays the 'off' output; "
                        "sampled requests decode normally")
    p.add_argument("--spec-k", type=int, default=4,
                   help="speculative decoding: most draft tokens a slot proposes a "
                        "verify step (the window is spec-k + 1 wide: one graph)")
    p.add_argument("--draft-model", default=None,
                   help="--spec draft: the draft model (.m, the target's vocab), "
                        "loaded onto the target's device with contiguous slot rows")
    p.add_argument("--no-sched-overlap", action="store_true",
                   help="slot scheduler: turn off the two-deep overlapped dispatch "
                        "pipeline and dispatch synchronously (greedy output is "
                        "byte-identical either way)")
    p.add_argument("--kv-reserve", choices=("full", "optimistic"), default="full",
                   help="paged KV: 'full' reserves every page a request can touch at "
                        "admission; 'optimistic' admits with ceil((prompt + "
                        "--spill-headroom)/page) pages and grows slots page by page, "
                        "reclaiming through radix eviction and a spill to host RAM")
    p.add_argument("--spill-headroom", type=int, default=16,
                   help="optimistic reservation: decode tokens of slack bound beyond "
                        "the prompt at admission and at a resume")
    p.add_argument("--kv-host-pool-mb", type=float, default=64.0,
                   help="KV tiering: pinned host-RAM budget (MiB) for spilled pages; "
                        "a spill that would not fit preempts instead (0: no spill).  "
                        "A Llama-2-7B bf16 page of 16 positions is 8 MiB")
    p.add_argument("--no-preempt", action="store_true",
                   help="QoS: admission stays priority-ordered, but a higher class "
                        "never evicts a running lower-class slot")
    p.add_argument("--preempt-age-ms", type=float, default=5000.0,
                   help="QoS: a queued request climbs one class per this many ms "
                        "waited (0: no aging; admission order only, never eviction)")
    p.add_argument("--preempt-cap", type=int, default=3,
                   help="QoS: times one request may be preempted and parked; past it "
                        "the victim finishes with finish_reason \"preempted\"")
    p.add_argument("--preempt-spill-dir", default=None,
                   help="QoS: keep preempted requests' DLREQ01 records in this "
                        "directory instead of RAM")
    p.add_argument("--snapshot-dir", default=None,
                   help="API server: at a drain save the engine's state, its "
                        "conversation cache and the paged pool with its radix tree "
                        "here (DLSNAP02); the next boot restores them (a corrupt or "
                        "mismatched file cold-starts)")
    p.add_argument("--handoff", action="store_true",
                   help="API server: a drain exports every live request as a DLREQ01 "
                        "record (GET /admin/export/<rid>), and POST /admin/import "
                        "resumes a peer's; needs --batch-slots and --kv-pages")
    p.add_argument("--handoff-ttl", type=float, default=0.0,
                   help="API server: seconds an exported record waits to be claimed "
                        "(0: until claimed)")
    p.add_argument("--max-pending", type=int, default=8,
                   help="requests in flight or queued before 429")
    p.add_argument("--request-timeout", type=float, default=0.0,
                   help="default per-request deadline in seconds (0: none)")
    # observability (obs/), the JAX CLI's flags
    p.add_argument("--log-format", choices=["human", "json"], default=None,
                   help="log output format: human-readable lines or JSON "
                        "lines (one object per record, grep-able by "
                        "request_id).  Default: DLLAMA_LOG env, else human")
    p.add_argument("--log-level", default=None,
                   choices=["debug", "info", "warning", "error"],
                   help="log verbosity for the dllama_tpu_torch logger tree "
                        "(default: DLLAMA_LOG env, else info)")
    p.add_argument("--trace-buffer", type=int, default=None,
                   help="span ring capacity for /debug/trace (default "
                        "DLLAMA_TRACE_BUFFER, else 8192)")
    p.add_argument("--flight-buffer", type=int, default=None,
                   help="flight-recorder ring capacity for /debug/requests "
                        "(default DLLAMA_FLIGHT_BUFFER, else 512)")
    p.add_argument("--event-buffer", type=int, default=None,
                   help="event-journal ring capacity for /debug/events "
                        "(default DLLAMA_EVENT_BUFFER, else 2048)")
    p.add_argument("--event-log", default=None, metavar="PATH",
                   help="also append every event-journal record as a JSONL "
                        "line to PATH (append mode: restarts extend)")
    p.add_argument("--slo", default=None, metavar="SPEC",
                   help="declarative latency/error objectives, e.g. "
                        "'ttft_p95=1500ms,itl_p99=120ms,error_rate=0.5%%'. "
                        "Burn rates over rolling windows (DLLAMA_SLO_WINDOWS, "
                        "default 5m,1h) feed slo_burn_rate gauges and the "
                        "/health verdict.  Default: DLLAMA_SLO env")
    # flags of the JAX CLI that this port does not carry yet
    for flag, default in NOT_PORTED_FLAGS.items():
        if isinstance(default, bool):
            p.add_argument(flag, action="store_true", help=argparse.SUPPRESS)
        else:
            p.add_argument(flag, default=default, help=argparse.SUPPRESS,
                           type=type(default) if default is not None else str)
    p.add_argument("--nthreads", type=int, default=0,
                   help="accepted for reference CLI parity; unused")
    p.add_argument("--sp", type=int, default=1, help=argparse.SUPPRESS)
    p.add_argument("--dp", type=int, default=1, help=argparse.SUPPRESS)
    p.add_argument("--ep", type=int, default=1, help=argparse.SUPPRESS)
    return p


def not_ported(args) -> list[str]:
    """The modes and flags of ``args`` that the port does not carry."""
    out = []
    if args.mode in NOT_PORTED_MODES:
        out.append(f"mode {args.mode!r}")
    for flag in ("sp", "dp", "ep"):
        if getattr(args, flag) != 1:
            out.append(f"--{flag}")
    for flag, default in NOT_PORTED_FLAGS.items():
        if getattr(args, flag[2:].replace("-", "_")) != default:
            out.append(flag)
    variant = os.environ.get("DLLAMA_Q40_VARIANT", "classic")
    if variant != "classic":
        out.append(f"DLLAMA_Q40_VARIANT={variant} (only classic)")
    return out


def load_stack(args, batch: int = 1, stack=None) -> tuple[Engine, Tokenizer]:
    """The model (loaded on the host, then uploaded by the Engine, which
    converts it to the blocked layout first when asked, or slices it over
    the ``--workers`` mesh) and its tokenizer; ``batch`` rows of
    contiguous cache.  ``stack``, an ``(engine, tokenizer)`` loaded before,
    gives the weights, device and mesh instead of ``--model`` (several
    servers of one model in one process, each with caches of its own)."""
    if stack is not None:
        base, tok = stack
        return _engine(args, base.cfg, base.params, base.device, base.mesh, batch), tok
    if not args.model or not args.tokenizer:
        raise SystemExit("--model and --tokenizer are required for this mode")
    device = resolve(args.device)
    try:
        mesh = parse_workers(args.workers, device)
    except ValueError as e:
        raise SystemExit(str(e)) from None
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
        print(f"💡 mesh: tp={mesh.tp}")
        try:
            check_tp_constraint(cfg, mesh.tp)
        except ValueError as e:
            raise SystemExit(str(e)) from None
        cfg, params = load_params(mf, cfg, fuse=mesh.tp == 1)
    engine = _engine(args, cfg, params, device, mesh, batch)
    tok = Tokenizer(tfile.read_tfile(args.tokenizer))
    if tok.vocab_size != cfg.vocab_size:
        raise SystemExit("tokenizer is incompatible with model (vocab size mismatch)")
    return engine, tok


def _engine(args, cfg, params, device, mesh, batch: int) -> Engine:
    kv_dtype = DTYPES.get(args.kv_cache_dtype, args.kv_cache_dtype)
    return Engine(cfg, params, seq_len=args.max_seq_len, kv_dtype=kv_dtype,
                  device=device, batch=batch, mesh=mesh)


def load_draft_engine(args, target: Engine) -> Engine:
    """Load ``--draft-model`` as a second, smaller Engine for ``--spec
    draft`` (``runtime/spec.py`` ``DraftModelProposer``): on the target's
    device (or mesh), with its slot count and context, contiguous slot rows
    (the draft's cache is small; paging would add indirection alone).  Its
    vocab must be the target's: drafted ids are target token ids."""
    if not args.draft_model:
        raise SystemExit("--spec draft needs --draft-model")
    bft = "bf16" if args.buffer_float_type == "q80" else args.buffer_float_type
    with mfile.MFile(args.draft_model) as mf:
        cfg = ModelConfig.from_spec(mf.spec, dtype=DTYPES[bft])
        if cfg.vocab_size != target.cfg.vocab_size:
            raise SystemExit("--draft-model vocab size differs from the target's "
                             "(drafted ids must be target token ids)")
        print(f"💡 draft arch: {mf.spec.arch_name} ({cfg.n_layers} layers, dim {cfg.dim})")
        cfg, params = load_params(mf, cfg, fuse=target.tp == 1)
    return Engine(cfg, params, seq_len=target.seq_len, device=target.device,
                  batch=target.batch, mesh=target.mesh)


def _pld_args(args) -> None:
    """``--pld``'s refusals (the JAX CLI's): greedy only, one stream."""
    if args.temperature != 0:
        raise SystemExit("--pld is greedy-only; set --temperature 0")


def profile_report(engine: Engine, ops: bool) -> None:
    """``--profile-split`` / ``--profile-ops``: a few decode steps of
    ``engine`` under ``torch.profiler`` (graph replays on the card), then
    the compute/collective split a step and the top kernels."""
    from .runtime.profiling import profile_decode_steps, summarize_split, top_ops
    n_steps = 3
    times, how = profile_decode_steps(engine, n_steps)
    if times is None:
        print("Profiled split:      unavailable (the trace holds no time)")
        return
    sp = summarize_split(times, n_steps)
    print(f"Profiled decode step ({how}; {engine.tp} rank(s), summed): "
          f"compute {sp['compute_ms']:.3f} ms, collectives {sp['collective_ms']:.3f} ms "
          f"({sp['collective_pct']:.1f}%)")
    for op, ms in top_ops(times, 10 if ops else 5, n_steps):
        print(f"  top op {ms:8.3f} ms  {op}")


def _seed(args) -> int:
    return args.seed if args.seed is not None else int(time.time())


def _encode_prompt(engine: Engine, tok: Tokenizer, prompt: str) -> list[int]:
    return tok.encode(prompt, add_bos=engine.cfg.add_bos)


def launch_line(engine: Engine) -> str:
    """End-of-run line: how often each matmul route of the model's codec
    ran (Q80 for a Q80 file, else Q40), per forward; for Q80, ``mma=``
    counts the kernel launches that took the tensor-core body.  A blocked-layout
    model counts kernel 3 (``blocked=``) apart from kernels 1–2
    (``kernel=``), and its per-forward figure is kernel 3's."""
    is_q8 = any(isinstance(v, q8.Q8Tensor) for v in engine.params.values())
    blocked = any(isinstance(v, q40.BlockedQTensor) for v in engine.params.values())
    name, c = ("q8", q8.counters()) if is_q8 else ("q40", q40.counters())
    launches = c["blocked_launches"] if blocked else c["kernel_launches"]
    per = launches / engine.forwards if engine.forwards else 0.0
    ar = q40.counters()
    return (f"💡 {name} launches: kernel={c['kernel_launches']} "
            + (f"blocked={c['blocked_launches']} " if blocked else "")
            + f"plain={c['plain_calls']} "
            + (f"mma={c['mma_launches']} " if is_q8 else "")
            + (f"allreduce={ar['allreduce_launches']} "
               f"allreduce_plain={ar['allreduce_plain_calls']} tp={engine.tp} "
               if engine.tp > 1 else "")
            + f"forwards={engine.forwards} kernel_per_forward={per:g} "
            + ("layout=blocked " if blocked else "")
            + f"device={engine.device.type}")


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
    if args.pld > 0:
        _pld_args(args)
        stream = ((tk, st) for toks, st in engine.pld_windows(ids, steps + len(ids),
                                                              k=args.pld)
                  for tk in toks)
    else:
        stream = engine.generate_stream(
            ids, steps + len(ids), temperature=args.temperature, topp=args.topp,
            seed=_seed(args), chunk=args.chunk)
    for token, st in stream:
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
    if args.pld > 0:
        w = engine.pld_stats
        per = (w["accepted"] + w["windows"]) / w["windows"] if w["windows"] else 0.0
        print(f"💡 pld: {w['windows']} verify windows of k={args.pld}, {w['accepted']} of "
              f"{w['proposed']} drafts accepted, {per:.2f} tokens a window")
    if args.profile_split or args.profile_ops:
        profile_report(engine, args.profile_ops)
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
    if args.pld > 0:
        _pld_args(args)
        stream = engine.generate_pld_stream(ids, steps, k=args.pld, eos_ids=eos)
    else:
        stream = (token for token, _ in engine.generate_stream(
            ids, steps, temperature=args.temperature, topp=args.topp,
            seed=_seed(args), eos_ids=eos, chunk=args.chunk))
    for token in stream:
        sys.stdout.write(tok.decode_piece(prev, token).decode("utf-8", errors="replace"))
        sys.stdout.flush()  # a window's tokens appear as it lands
        prev = token
    print()
    print(launch_line(engine))
    return engine


def cmd_batch(args) -> Engine:
    """Distinct prompts (``--prompts-file``, one a line, or one
    ``--prompt``) in one lockstep decode; each stream is printed under its
    own header after the batch, then the aggregate throughput: the decode
    matmuls read each weight once for all rows."""
    if args.prompts_file:
        with open(args.prompts_file, "r", encoding="utf-8") as f:
            prompts = [ln.rstrip("\r\n") for ln in f if ln.strip()]
    elif args.prompt is not None:
        prompts = [args.prompt]
    else:
        raise SystemExit("batch mode requires --prompts-file or --prompt")
    engine, tok = load_stack(args, batch=len(prompts))
    id_lists = [_encode_prompt(engine, tok, p) for p in prompts]
    steps = args.steps or engine.seq_len
    eos = (tok.eos_id,) if tok.eos_id >= 0 else ()
    t0 = time.perf_counter()
    outs = engine.generate_batch(id_lists, steps, temperature=args.temperature,
                                 topp=args.topp, seed=_seed(args), eos_ids=eos,
                                 chunk=args.chunk)
    dt = time.perf_counter() - t0
    generated = sum(len(o) - len(p) for o, p in zip(outs, id_lists))
    for r, o in enumerate(outs):
        print(f"▶ stream {r}")
        print(tok.decode(o))
    print(f"Generated tokens:    {generated} over {len(prompts)} streams")
    if dt > 0:
        print(f"Batched throughput:  {generated / dt:.2f} tok/s")
    print(launch_line(engine))
    return engine


def cmd_chat(args) -> Engine:
    """Multi-turn REPL on stdin, one KV cache a conversation.  One sampler
    stream a session: the seed is resolved once, and later turns continue
    the stream."""
    engine, tok = load_stack(args)
    stops = TokenizerChatStops(tok)
    template = ChatTemplate(tok.chat_template,
                            tok.vocab[tok.chat_eos_id].decode("utf-8", "replace"))
    eos_detector = EosDetector(tok.chat_eos_id, stops.stops,
                               padding_left=2, padding_right=2)

    print("💻 System prompt (optional): ", end="", flush=True)
    system = sys.stdin.readline().strip()
    first = True
    session_seed: int | None = _seed(args)
    while True:
        print("\n👱 User\n> ", end="", flush=True)
        user = sys.stdin.readline()
        if not user:
            print()  # end the prompt line before the launch line
            break
        user = user.strip()
        if not user:
            continue
        items = []
        if first and system:
            items.append(ChatItem("system", system))
        items.append(ChatItem("user", user))
        first = False
        text = template.generate(items, True)
        ids = tok.encode(text, add_bos=engine.pos == 0)
        if engine.pos + len(ids) + 2 >= engine.seq_len:
            print("🚫 context window is full")
            break
        print("\n🤖 Assistant")
        eos_detector.clear()
        prompt_end = engine.pos + len(ids)
        stream = engine.generate_stream(
            ids, engine.seq_len - engine.pos, temperature=args.temperature,
            topp=args.topp, seed=session_seed, chunk=args.chunk,
            eos_ids=(tok.chat_eos_id,))
        session_seed = None  # continue the session stream on later turns

        def emit(delta):
            sys.stdout.write(delta)
            sys.stdout.flush()

        drain_generation(engine, tok, eos_detector, stream, len(ids), prompt_end, emit)
        print()
    print(launch_line(engine))
    return engine


def configure_obs(args):
    """Apply the observability flags (log format and level, ring sizes,
    the event log) and build the ``--slo`` engine (``DLLAMA_SLO`` when the
    flag is absent); returns it, or None.  A bad spec exits naming it."""
    from .obs import events as obs_events, flight as obs_flight, trace as obs_trace
    from .obs.log import configure as configure_logging
    from .obs.slo import SloEngine
    configure_logging(args.log_format, args.log_level)
    obs_trace.configure(args.trace_buffer)
    obs_flight.configure(args.flight_buffer)
    obs_events.configure(args.event_buffer, args.event_log)
    spec = args.slo or os.environ.get("DLLAMA_SLO", "")
    if not spec:
        return None
    try:
        return SloEngine.from_spec(spec)
    except ValueError as e:
        raise SystemExit(f"--slo: {e}") from None


def main(argv=None) -> Engine:
    """Run one command; returns its Engine (for callers in-process)."""
    args = build_parser().parse_args(argv)
    missing = not_ported(args)
    if missing:
        raise SystemExit(f"not yet ported to dllama_tpu_torch: {', '.join(missing)} "
                         "(run python -m dllama_tpu for these)")
    slo = configure_obs(args)
    engine = {"inference": cmd_inference, "generate": cmd_generate, "chat": cmd_chat,
              "batch": cmd_batch}[args.mode](args)
    if slo is not None:
        print(slo.summary_line())
    return engine


if __name__ == "__main__":
    main()
