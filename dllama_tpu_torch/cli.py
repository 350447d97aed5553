"""`dllama_tpu_torch` command line: ``inference | generate | chat | batch |
worker | router | serve-pod``.

The port of ``dllama_tpu/cli.py``'s single-host modes, with the same
flags where they apply, plus ``--device {cuda,cpu}`` (default ``cuda``;
asking for ``cuda`` where there is none is an error):

* ``inference`` — benchmark mode: per-token ``G/I/T`` lines + run averages.
* ``generate``  — stream text for ``--steps`` tokens.
* ``chat``      — multi-turn REPL on stdin, one KV cache a conversation.
* ``batch``     — the prompts of ``--prompts-file`` (one a line) decoded
  as one lockstep ragged batch.
* ``worker``    — join a process group as one of its processes and run
  ``--program`` (``generate``, ``inference`` or ``batch``) over this
  process's ranks; without coordinates it explains the mapping.
* ``router``    — the fleet router in front of ``--backends host:port,...``
  (``router/service.py``; no model in this process).
* ``serve-pod`` — ``--dp`` replicas of the API server behind the router on
  ``--port`` (``router/pod.py``): in this process, the model read once, or
  with ``--supervise`` as child processes that a supervisor respawns;
  ``--supervise --elastic`` grows, shrinks and reshapes them
  (``router/elastic.py``).

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
``torch.profiler`` after the run (``runtime/profiling.py``).
``--verify-weights`` checks each tensor against the model's checksum
manifest (``io/integrity.py``); ``--step-timeout`` and
``--numeric-checks`` arm the engine's watchdog and logits guard.
``--weights-float-type`` names the weights' type of a file whose header
does not (the reference's legacy-magic files); ``--dequantize`` loads Q40
and Q80 weights dense in the compute dtype (their products plain
matmuls).

A process group (``parallel/distributed.py``): every process runs the same
command with its coordinates, ``--coordinator host:port --nproc N
--proc-id K`` (or the DLLAMA_COORDINATOR/DLLAMA_NPROC/DLLAMA_PROC_ID
variables); process 0 runs a mode (``generate``, ``inference``,
``batch``), the others ``worker --program`` of it, or the mode itself.
Each process holds ``tp / N`` of the ``--workers tpu:tp`` ranks
(``parallel/mesh.py``); only process 0 prints (the others' stdout goes to
``os.devnull``), and each process ends with one JSON line of its launch
counters on stderr.  ``chat``, ``router``, ``serve-pod`` and ``--pld`` are
refused with coordinates.

``--sp``, ``--ep`` and ``--dp`` add the JAX mesh's other axes to
``inference``, ``generate``, ``chat`` and ``batch`` in one process
(``parallel/mesh.py``: ``dp × sp × ep × tp`` ranks): sp cuts the KV
cache's sequence axis (ring prefill, the one-round decode combine of
``ops/sp_attention.py``), ep a MoE model's expert stacks (only an expert's
owner runs it), dp the batch rows (``batch``: distinct prompts, a multiple
of dp of them; the single-prompt modes: dp replicas of the prompt, stream
0 printed).  What the port leaves out exits naming it as not yet ported:
any of them over a process group, and ``--dp`` on the API server (where
``--sp`` needs no ``--batch-slots``); ``serve-pod`` refuses ``--sp`` and
``--ep`` as the JAX package does.

``python -m dllama_tpu_torch inference --model m.m --tokenizer t.t``
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from . import quants
from .device import DEVICES, resolve
from .io import mfile, tfile
from .models.config import ModelConfig
from .models.params import load_params, load_placed
from .ops import q8, q40
from .parallel import distributed
from .parallel.mesh import check_split, parse_workers, workers_tp
from .parallel.sharding import check_ep_constraint, check_tp_constraint
from .runtime.engine import Engine, RunStats
from .runtime.stream import drain_generation
from .tokenizer.bpe import Tokenizer
from .tokenizer.chat import ChatItem, ChatTemplate, TokenizerChatStops
from .tokenizer.eos import EosDetector

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}
MODES = ("inference", "generate", "chat", "batch", "worker", "router", "serve-pod")
NOT_PORTED_MODES: tuple[str, ...] = ()
# flags of the JAX CLI that the port does not carry, with the JAX defaults:
# a value other than the default exits naming the flag
NOT_PORTED_FLAGS: dict = {}
# modes that do not run over a process group
ONE_PROCESS_MODES = ("chat", "router", "serve-pod")


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
    p.add_argument("--weights-float-type", choices=list(quants.FLOAT_TYPE_BY_NAME),
                   default=None,
                   help="the weights' float type of a model file whose header names "
                        "none (the reference's legacy-magic files); a header's own "
                        "wins")
    p.add_argument("--dequantize", action="store_true",
                   help="load Q40/Q80 weights dense in the compute dtype instead of "
                        "packed for their kernels (their products then run as plain "
                        "matmuls; for numerics comparison)")
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
    # a process group (parallel/distributed.py), the JAX CLI's flags
    p.add_argument("--coordinator", default=None,
                   help="multi-process: process-0 host:port for the process group "
                        "(parallel/distributed.py); every process runs the same "
                        "command with the same model flags")
    p.add_argument("--nproc", type=int, default=None,
                   help="multi-process: total process count")
    p.add_argument("--proc-id", type=int, default=None,
                   help="multi-process: this process's id (0 = root)")
    p.add_argument("--program", choices=list(WORKER_PROGRAMS), default="generate",
                   help="worker mode: which root program this worker mirrors (every "
                        "process runs the same program over its own ranks)")
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
    p.add_argument("--io-timeout", type=float, default=15.0,
                   help="API server: socket read/write timeout; a client stalled "
                        "sending its body gets 408, one stalled reading a stream "
                        "is treated as disconnected")
    p.add_argument("--drain-grace", type=float, default=30.0,
                   help="API server: on SIGTERM/SIGINT, seconds granted to "
                        "in-flight requests before their deadlines clamp")
    p.add_argument("--step-timeout", type=float, default=None,
                   help="watchdog: seconds a device step may take to land before "
                        "StepTimeout (default DLLAMA_STEP_TIMEOUT, else none); the "
                        "server then answers 500 and marks itself degraded "
                        "(/health 503)")
    p.add_argument("--numeric-checks", action="store_true",
                   help="check every host-fetched logits array for NaN/Inf and "
                        "raise NumericFault (step, pos) instead of emitting garbage "
                        "(default DLLAMA_NUMERIC_CHECKS)")
    p.add_argument("--verify-weights", action="store_true",
                   help="verify each tensor's crc32 against the model's checksum "
                        "manifest (<model>.m.sum, written by python -m "
                        "dllama_tpu_torch.io.integrity write) on first read; the "
                        "header digest is verified whenever the manifest exists")
    # the fleet router (router mode, and serve-pod's front)
    p.add_argument("--backends", default=None,
                   help="router mode: comma-separated replica addresses (host:port,...)")
    p.add_argument("--probe-interval", type=float, default=2.0,
                   help="router: seconds between /health probes of each backend")
    p.add_argument("--eject-after", type=int, default=3,
                   help="router: consecutive probe/dispatch failures before a "
                        "backend is ejected")
    p.add_argument("--readmit-after", type=int, default=2,
                   help="router: consecutive healthy probes before an ejected "
                        "backend is re-admitted")
    p.add_argument("--router-retries", type=int, default=2,
                   help="router: re-dispatches of a request whose backend failed "
                        "before any response bytes were forwarded")
    p.add_argument("--upstream-timeout", type=float, default=120.0,
                   help="router: socket timeout per upstream request (connect and "
                        "each read)")
    p.add_argument("--stall-timeout", type=float, default=0.0,
                   help="router: seconds an open upstream stream may stay silent "
                        "before its replica is treated as dead (force-ejected) and "
                        "the stream resumed elsewhere; it bounds time to first token "
                        "too, so set it above queue + prefill + the kernels' first "
                        "build.  0: off")
    p.add_argument("--checkpoint-interval", type=float, default=0.0,
                   help="router: seconds between DLREQ01 checkpoints of each "
                        "in-flight greedy stream (GET /admin/checkpoint/<rid>; "
                        "replicas need --handoff); a lost replica's streams resume "
                        "from the latest.  0: off (resume re-runs the request)")
    p.add_argument("--resume-policy", choices=["auto", "never"], default="auto",
                   help="router: auto resumes greedy streams on a peer after a "
                        "mid-stream loss (sampled ones end replica_lost); never "
                        "turns resume off.  Per request: the body's resume_policy")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel degree: shards the KV cache's "
                        "sequence axis over the mesh for long context "
                        "(beyond-reference capability; see ops/sp_attention.py)")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel degree: shards the batch axis over a "
                        "dp mesh axis (beyond-reference capability). In "
                        "batch mode the dp shards carry DISTINCT prompts; "
                        "in the single-prompt modes the dp rows are "
                        "replicas and only stream 0 is printed.  serve-pod: "
                        "replicas, each --workers tpu:N ranks wide (--device "
                        "cuda: replica r on cards r*N..r*N+N-1; cuda:K: every "
                        "replica on card K; cpu: the CPU)")
    p.add_argument("--ep", type=int, default=1,
                   help="expert-parallel degree for MoE models: expert "
                        "stacks — dense AND packed Q40/Q80 — shard over experts "
                        "instead of replicating (beyond-reference; the "
                        "reference TP-slices all experts everywhere, "
                        "transformer.cpp:299-317; packed path: ops/q40.py "
                        "ep_matmul, only an expert's owner reads its tiles)")
    p.add_argument("--supervise", action="store_true",
                   help="serve-pod: run each replica as a child process under a "
                        "supervisor that respawns it when it dies or its /health "
                        "stops answering 200; a crash-looping replica is "
                        "quarantined (--respawn-max/--respawn-window)")
    p.add_argument("--respawn-max", type=int, default=5,
                   help="serve-pod --supervise: deaths tolerated inside "
                        "--respawn-window before a replica is quarantined")
    p.add_argument("--respawn-window", type=float, default=30.0,
                   help="serve-pod --supervise: sliding window (seconds) of the "
                        "crash-loop count")
    # the elastic pod (router/elastic.py), the JAX CLI's flags
    p.add_argument("--elastic", action="store_true",
                   help="serve-pod --supervise: load-driven autoscaling "
                        "and live tp reshape — a control loop samples "
                        "fleet /health signals and spawns, drains, or "
                        "reshapes replicas within the --pod-devices "
                        "budget.  Needs --handoff + --batch-slots/"
                        "--kv-pages (in-flight requests migrate over "
                        "the hand-off wire)")
    p.add_argument("--pod-devices", type=int, default=0,
                   help="serve-pod --elastic: total device budget the "
                        "pod may partition into replicas (default "
                        "dp × tp — no headroom to grow)")
    p.add_argument("--min-replicas", type=int, default=1,
                   help="serve-pod --elastic: scale-down floor")
    p.add_argument("--max-replicas", type=int, default=0,
                   help="serve-pod --elastic: scale-up ceiling "
                        "(default: the boot dp)")
    p.add_argument("--elastic-interval", type=float, default=2.0,
                   help="serve-pod --elastic: seconds between control-"
                        "loop ticks (one fleet sample per tick)")
    p.add_argument("--elastic-window", type=int, default=5,
                   help="serve-pod --elastic: samples in the sliding "
                        "window; EVERY sample must agree before a "
                        "policy action fires (sustained signal, not a "
                        "spike)")
    p.add_argument("--elastic-cooldown", type=float, default=30.0,
                   help="serve-pod --elastic: seconds after any "
                        "topology action before the policy may act "
                        "again (the window also refills from empty)")
    p.add_argument("--scale-up-util", type=float, default=0.85,
                   help="serve-pod --elastic: sustained fleet slot "
                        "utilization at or above this adds a replica")
    p.add_argument("--scale-down-util", type=float, default=0.15,
                   help="serve-pod --elastic: sustained utilization at "
                        "or below this (with an empty queue) retires "
                        "the most-idle replica")
    p.add_argument("--scale-up-queue", type=float, default=2.0,
                   help="serve-pod --elastic: sustained queued requests "
                        "per replica at or above this also triggers "
                        "scale-up")
    p.add_argument("--reshape-kv-low", type=float, default=0.08,
                   help="serve-pod --elastic: sustained effective-free "
                        "KV fraction at or below this reshapes to "
                        "fewer, wider replicas (tp×2) — the long-"
                        "context answer")
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
    return p


def in_group(args) -> bool:
    """Does ``args`` (or the environment) give process-group coordinates?"""
    return bool(args.coordinator or args.nproc is not None or args.proc_id is not None
                or distributed.distributed_env() is not None)


def not_ported(args, server: bool = False) -> list[str]:
    """The modes and flags of ``args`` that the port does not carry: the
    mesh's sp, ep and dp axes over a process group, and (``server``, the
    API server's flags) ``--dp`` there."""
    out = []
    if args.mode in NOT_PORTED_MODES:
        out.append(f"mode {args.mode!r}")
    if in_group(args):
        out += [f"--{a} over a process group" for a in ("sp", "ep", "dp")
                if getattr(args, a) != 1]
    elif server and args.dp != 1:
        out.append("--dp on the API server")
    for flag, default in NOT_PORTED_FLAGS.items():
        if getattr(args, flag[2:].replace("-", "_")) != default:
            out.append(flag)
    return out


def check_q40_variant() -> None:
    """Refuse an unknown ``DLLAMA_Q40_VARIANT`` (read when ``ops.q40`` was
    imported) before any weight is read, with the JAX package's error,
    which it raises at the first Q40 matmul."""
    try:
        q40.check_variant()
    except ValueError as e:
        raise SystemExit(f"DLLAMA_Q40_VARIANT: {e}") from None


def load_stack(args, batch: int | None = None, stack=None) -> tuple[Engine, Tokenizer]:
    """The model (loaded on the host, then uploaded by the Engine, which
    converts it to the blocked layout first when asked, or slices it over
    the mesh of ``--workers``, ``--sp``, ``--ep`` and ``--dp``) and its
    tokenizer; ``batch`` rows of contiguous cache (default: the mesh's dp,
    the JAX CLI's ``max(dp, 1)``).  ``stack``, an ``(engine, tokenizer)``
    loaded before, gives the weights, device and mesh instead of
    ``--model`` (several servers of one model in one process, each with
    caches of its own)."""
    if stack is not None:
        base, tok = stack
        return _engine(args, base.cfg, base.params, base.device, base.mesh, batch or 1), tok
    if not args.model or not args.tokenizer:
        raise SystemExit("--model and --tokenizer are required for this mode")
    device = resolve(args.device)
    try:
        mesh = parse_workers(args.workers, device, distributed.current_group(),
                             sp=args.sp, dp=args.dp, ep=args.ep)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "host"
    cfg, params, tok = read_model(args, mesh.tp, f"{device} ({name})", mesh)
    return _engine(args, cfg, params, device, mesh, batch or mesh.dp), tok


#: seconds the newest :func:`read_model` took to read the weights on the
#: host (checksums included under ``--verify-weights``)
last_read_s: float | None = None


def read_model(args, tp: int, where: str, mesh=None) -> tuple[ModelConfig, dict, Tokenizer]:
    """The ``--model`` file's config and host params (fused for tp = 1),
    checksum-verified under ``--verify-weights``, and the ``--tokenizer``;
    prints the model's shape, ``where`` it runs and the tp degree.  Exits
    when tp does not divide the model or the vocabularies differ.  Over a
    ``mesh`` that spans processes the params are this process's ranks'
    slices, placed (``models.params.load_placed``).  Prints the mesh's
    axes above 1 as the JAX CLI does (``💡 mesh: dp=2 sp=2``); exits on an
    ep the model refuses."""
    global last_read_s
    if not args.model or not args.tokenizer:
        raise SystemExit("--model and --tokenizer are required for this mode")
    bft = args.buffer_float_type
    if bft == "q80":
        print("💡 bufferFloatType q80 → bf16 (activations stay on the device; "
              "Q80's wire compression has no wire to compress here)")
        bft = "bf16"
    t0 = time.perf_counter()
    with mfile.MFile(args.model, verify=args.verify_weights,
                     weights_ftype=weights_ftype(args)) as mf:
        cfg = ModelConfig.from_spec(mf.spec, dtype=DTYPES[bft])
        print(f"💡 arch: {mf.spec.arch_name}")
        print(f"💡 dim: {cfg.dim}\n💡 nLayers: {cfg.n_layers}\n💡 nHeads: {cfg.n_heads}")
        print(f"💡 nKvHeads: {cfg.n_kv_heads}\n💡 vocabSize: {cfg.vocab_size}\n💡 seqLen: {cfg.seq_len}")
        print(f"💡 device: {where}")
        print(f"💡 mesh: {mesh.axes_line() if mesh is not None else f'tp={tp}'}")
        try:
            check_tp_constraint(cfg, tp)
            check_ep_constraint(cfg, mesh.ep if mesh is not None else 1)
        except ValueError as e:
            raise SystemExit(str(e)) from None
        if mesh is not None and mesh.multi:
            print(f"💡 processes: {mesh.nproc}, ranks {mesh.rank0}..{mesh.rank0 + len(mesh.devices) - 1} "
                  f"in process {mesh.proc}")
            params = load_placed(mf, cfg, mesh, keep_quantized=not args.dequantize)
        else:
            cfg, params = load_params(mf, cfg, fuse=tp == 1,
                                      keep_quantized=not args.dequantize)
    last_read_s = time.perf_counter() - t0
    tok = Tokenizer(tfile.read_tfile(args.tokenizer))
    if tok.vocab_size != cfg.vocab_size:
        raise SystemExit("tokenizer is incompatible with model (vocab size mismatch)")
    return cfg, params, tok


def weights_ftype(args) -> int | None:
    """``--weights-float-type`` as the file format's code, or None."""
    name = args.weights_float_type
    return quants.FLOAT_TYPE_BY_NAME[name] if name else None


def _engine(args, cfg, params, device, mesh, batch: int) -> Engine:
    kv_dtype = DTYPES.get(args.kv_cache_dtype, args.kv_cache_dtype)
    return Engine(cfg, params, seq_len=args.max_seq_len, kv_dtype=kv_dtype,
                  device=device, batch=batch, mesh=mesh, step_timeout=args.step_timeout,
                  numeric_checks=True if args.numeric_checks else None)


def load_draft_engine(args, target: Engine) -> Engine:
    """Load ``--draft-model`` as a second, smaller Engine for ``--spec
    draft`` (``runtime/spec.py`` ``DraftModelProposer``): on the target's
    device (or mesh), with its slot count and context, contiguous slot rows
    (the draft's cache is small; paging would add indirection alone).  Its
    vocab must be the target's: drafted ids are target token ids."""
    if not args.draft_model:
        raise SystemExit("--spec draft needs --draft-model")
    bft = "bf16" if args.buffer_float_type == "q80" else args.buffer_float_type
    with mfile.MFile(args.draft_model, weights_ftype=weights_ftype(args)) as mf:
        cfg = ModelConfig.from_spec(mf.spec, dtype=DTYPES[bft])
        if cfg.vocab_size != target.cfg.vocab_size:
            raise SystemExit("--draft-model vocab size differs from the target's "
                             "(drafted ids must be target token ids)")
        print(f"💡 draft arch: {mf.spec.arch_name} ({cfg.n_layers} layers, dim {cfg.dim})")
        cfg, params = load_params(mf, cfg, fuse=target.tp == 1,
                                  keep_quantized=not args.dequantize)
    return Engine(cfg, params, seq_len=target.seq_len, device=target.device,
                  batch=target.batch, mesh=target.mesh)


def _pld_args(args) -> None:
    """``--pld``'s refusals (the JAX CLI's): greedy only, one stream."""
    if args.temperature != 0:
        raise SystemExit("--pld is greedy-only; set --temperature 0")
    if args.dp > 1 or args.sp > 1:
        raise SystemExit("--pld is single-stream; drop --dp/--sp "
                         "(tp/ep meshes are fine)")


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
    if engine.group is not None:
        print(f"💡 profiled on process 0's {len(engine.mesh.devices)} rank(s); its kernel-4 "
              "time includes the wait for the other processes' partials")
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
    nproc = engine.group.count if engine.group is not None else 1
    return (f"💡 {name} launches: kernel={c['kernel_launches']} "
            + (f"blocked={c['blocked_launches']} " if blocked else "")
            + f"plain={c['plain_calls']} "
            + (f"mma={c['mma_launches']} " if is_q8 else "")
            + (f"allreduce={ar['allreduce_launches']} "
               f"allreduce_plain={ar['allreduce_plain_calls']} {engine.mesh.axes_line()} "
               if engine.mesh is not None else "")
            + (f"allreduce_ipc={ar['allreduce_ipc_launches']} "
               f"allreduce_gloo={ar['allreduce_gloo_calls']} nproc={nproc} "
               if nproc > 1 else "")
            + f"forwards={engine.forwards} kernel_per_forward={per:g} "
            + ("layout=blocked " if blocked else "")
            + f"device={engine.device.type}")


def end_of_run(engine: Engine) -> None:
    """A worker group's last words: every process's token stream checked
    against the others' (a mismatch raises on every process), then this
    process's launch counters as one JSON line on stderr, with its peak
    device memory (PyTorch's allocator) and the bytes of its CUDA IPC
    regions (allocated outside it)."""
    if engine.group is None:
        return
    engine.check_agreement()
    c = {name: {k: v for k, v in mod.counters().items() if k != "launches_by_shape"}
         for name, mod in (("q40", q40), ("q8", q8))}
    cuda = engine.device.type == "cuda"
    regions = engine.group.regions.values()
    print(json.dumps({"process": engine.group.index, "nproc": engine.group.count,
                      "forwards": engine.forwards, **c,
                      "peak_bytes": torch.cuda.max_memory_allocated(engine.device) if cuda
                      else 0,
                      "ipc_bytes": sum(r.nbytes * len(r.own) for r in regions)}),
          file=sys.stderr, flush=True)


def cmd_inference(args) -> Engine:
    """Benchmark mode: prints per-token G/I/T."""
    engine, tok = load_stack(args)
    ids = _encode_prompt(engine, tok, args.prompt or "Hello world")
    steps = args.steps or 64
    if engine.group is not None:
        print(f"💡 G/I/T are process 0's own times; kernel 4's share includes the wait "
              f"for the {engine.group.count - 1} other process(es)' partials")
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
    end_of_run(engine)
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
    end_of_run(engine)
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
    if args.dp > 1 and len(prompts) % args.dp:
        raise SystemExit(f"{len(prompts)} prompts do not shard over dp={args.dp}")
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
    end_of_run(engine)
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


def cmd_worker(args) -> Engine | None:
    """Join a process group as one of its processes (the reference's TCP
    worker, dllama.cpp:205-219, which executes the root's task list,
    tasks.cpp:230-256) and run ``--program`` over this process's ranks.
    Without coordinates there is nothing to join: the mapping is printed
    and the mode exits 0."""
    if not args.coordinator and distributed.distributed_env() is None:
        print("Within one host the reference's worker processes are the ranks of one\n"
              "program: run the root command with --workers tpu:N, the ranks on cards\n"
              "0..N-1 (--device cuda), all on card K (--device cuda:K) or on the CPU\n"
              "(--device cpu).  To split the ranks over processes, start this mode in\n"
              "every process but the root with --coordinator host:port --nproc N\n"
              "--proc-id K and the same --model/--tokenizer/--prompt/--workers flags;\n"
              "process 0 prints, the rest compute (reference: dllama.cpp:205-219 TCP\n"
              "worker; here gloo carries the host traffic and, on the card, kernel 4\n"
              "reads its peers' partials through CUDA IPC — one host; see\n"
              "dllama_tpu_torch/parallel/distributed.py)")
        return None
    return WORKER_PROGRAMS[args.program](args)


def cmd_router(args) -> None:
    """The fleet router in front of ``--backends`` (router/service.py): no
    model in this process, it only proxies HTTP."""
    from .router.service import main as router_main
    router_main(args)


def cmd_serve_pod(args) -> None:
    """``--dp`` replicas of the API server, each ``--workers tpu:N`` ranks
    wide, fronted by the fleet router on ``--port`` (router/pod.py)."""
    from .router.pod import main as pod_main
    pod_main(args)


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


# One table drives the --program choices AND the worker dispatch, so a
# new mirrored program cannot be added to one and missed in the other
# (chat stays out: interactive, one process only).
WORKER_PROGRAMS = {"generate": cmd_generate, "inference": cmd_inference,
                   "batch": cmd_batch}


def join_group(args) -> None:
    """With coordinates (flags or DLLAMA_* variables): refuse what does
    not run over a process group, check that ``--workers`` splits over the
    processes (before any connection), join the group, and send the stdout
    of every process but 0 to ``os.devnull``."""
    if not args.coordinator and distributed.distributed_env() is None:
        return
    if args.mode in ONE_PROCESS_MODES:
        raise SystemExit(f"mode {args.mode!r} does not run over a process group "
                         "(--coordinator/--nproc/--proc-id): the group's programs are "
                         f"{', '.join(WORKER_PROGRAMS)}, as worker --program or as the mode")
    if args.pld:
        raise SystemExit("--pld is not yet ported over a process group "
                         "(--coordinator/--nproc/--proc-id): run it in one process")
    env = distributed.distributed_env() or (None, None, None)
    nproc = args.nproc if args.nproc is not None else env[1]
    try:
        check_split(workers_tp(args.workers), nproc or 1)
        distributed.init_distributed(args.coordinator, args.nproc, args.proc_id)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    if not distributed.is_output_process():
        sys.stdout = open(os.devnull, "w")


def main(argv=None) -> Engine | None:
    """Run one command; returns its Engine (for callers in-process; None
    for ``router``, ``serve-pod`` and ``worker`` without coordinates)."""
    args = build_parser().parse_args(argv)
    missing = not_ported(args)
    if missing:
        raise SystemExit(f"not yet ported to dllama_tpu_torch: {', '.join(missing)} "
                         "(run python -m dllama_tpu for these)")
    check_q40_variant()
    slo = configure_obs(args)
    join_group(args)
    engine = {"inference": cmd_inference, "generate": cmd_generate, "chat": cmd_chat,
              "batch": cmd_batch, "worker": cmd_worker, "router": cmd_router,
              "serve-pod": cmd_serve_pod}[args.mode](args)
    if slo is not None:
        print(slo.summary_line())
    return engine


if __name__ == "__main__":
    main()
