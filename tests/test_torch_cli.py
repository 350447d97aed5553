"""The port's CLI (python -m dllama_tpu_torch) driven end to end on the CPU,
against the JAX package's CLI, plus the port's isolation from JAX: it
imports neither ``jax`` nor anything of ``dllama_tpu``."""

import os
import re
import subprocess
import sys

import pytest
import torch

from dllama_tpu import quants
from dllama_tpu.io import mfile
from fixtures import REPO, cpu_env, run_cli, write_tiny_model, write_tiny_tokenizer

PORT = os.path.join(REPO, "dllama_tpu_torch")


@pytest.fixture(scope="module")
def model_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    m, t = d / "tiny.m", d / "tiny.t"
    write_tiny_model(m, ftype=quants.Q40)
    write_tiny_tokenizer(t)
    return str(m), str(t)


def run_port(args, timeout=120) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, "-m", "dllama_tpu_torch", *args], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=timeout)


def _text(stdout: str) -> list[str]:
    """Output lines other than the 💡 banner/summary lines."""
    return [ln for ln in stdout.splitlines() if not ln.startswith("💡")]


def test_greedy_generate_byte_identical_to_jax(model_files):
    m, t = model_files
    args = ["generate", "--model", m, "--tokenizer", t, "--prompt", "hello",
            "--steps", "24", "--temperature", "0", "--buffer-float-type", "f32"]
    port = run_port(args + ["--device", "cpu"])
    assert port.returncode == 0, port.stderr[-2000:]
    ref = run_cli(args)
    assert ref.returncode == 0, ref.stderr[-2000:]
    assert _text(port.stdout) == _text(ref.stdout)
    assert len(_text(port.stdout)[0]) > len("<s>hello")
    # 24 steps = 2 prompt tokens + 22 generated: 1 prefill + 21 decode forwards,
    # each 2 layers x (wqkv, wo, w13, w2) + wcls = 9 plain matmuls on the CPU
    assert port.stdout.splitlines()[-1] == (
        "💡 q40 launches: kernel=0 plain=198 forwards=22 "
        "kernel_per_forward=0 device=cpu")


def test_inference_prints_stats(model_files):
    m, t = model_files
    r = run_port(["inference", "--model", m, "--tokenizer", t, "--prompt", "hello",
                  "--steps", "8", "--temperature", "0", "--warmup", "4",
                  "--chunk", "4", "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    out = r.stdout
    assert out.count("🔶 G") == 10  # 2 prompt tokens + 8 generated
    for line in ("Generated tokens:    8", "Avg tokens / second:",
                 "Avg generation time:", "Avg inference time:",
                 "Avg transfer time:", "Avg sent / recv:", "💡 warmup: 4 tokens"):
        assert line in out
    assert out.splitlines()[-1].startswith("💡 q40 launches: kernel=0 ")


@pytest.mark.parametrize("extra,named", [
    # worker and the process group's flags are ported since the worker
    # slice: the cases that named them keep their ids, hold that they are
    # accepted, and name a flag still outside the port beside them (--sp)
    pytest.param(["worker", "--sp", "2"], "--sp", id="extra0-mode 'worker'"),
    (["generate", "--workers", "tpu:2", "--ep", "2"], "--ep"),
    # --pld is ported since: the case keeps its id and names --sp alone
    pytest.param(["generate", "--pld", "4", "--sp", "2"], "--sp", id="extra2---sp, --pld"),
    # this case's flags are ported now: it keeps its name and holds that,
    # beside them, the flags still outside the port are named (--step-timeout
    # is ported since the fleet slice: --sp stands in for it)
    pytest.param(["generate", "--kv-reserve", "optimistic", "--snapshot-dir", "x",
                  "--spec", "pld", "--step-timeout", "5", "--sp", "2"], "--sp",
                 id="extra3---kv-reserve, --snapshot-dir"),
    # the router and serve-pod modes and their flags are ported since, and
    # the elastic pod's flags since the elastic slice: each case keeps its id
    # and names a flag still outside the port beside them (--sp, --coordinator)
    pytest.param(["router", "--backends", "127.0.0.1:1", "--elastic", "--sp", "2"], "--sp",
                 id="extra4-mode 'router', --backends"),
    pytest.param(["serve-pod", "--supervise", "--dp", "2", "--pod-devices", "4", "--sp", "2"],
                 "--sp", id="extra5-mode 'serve-pod', --supervise"),
    # the loading flags are ported since: the case keeps its id and holds
    # that they are accepted, named the flag still outside the port beside them
    pytest.param(["generate", "--dequantize", "--weights-float-type", "q40", "--elastic",
                  "--coordinator", "h:1", "--sp", "2"], "--sp",
                 id="extra6---weights-float-type, --dequantize"),
    # the profiling flags are ported since: the case keeps its id and runs
    # them beside a flag still outside the port (--dequantize is ported
    # since the loading flags came over, --min-replicas since the elastic
    # slice: --sp stands in for them)
    pytest.param(["inference", "--profile-split", "--profile-ops", "--numeric-checks",
                  "--dequantize", "--min-replicas", "2", "--sp", "2"], "--sp",
                 id="extra7---profile-split, --profile-ops"),
    # (--program chat is refused by argparse, as by the JAX CLI: chat is no
    # worker program; batch stands in for it)
    pytest.param(["worker", "--coordinator", "h:1", "--nproc", "2", "--proc-id", "1",
                  "--program", "batch", "--sp", "2"], "--sp",
                 id="extra8---coordinator, --nproc, --proc-id, --program"),
    # the elastic flags are ported since: the two cases keep their ids, run
    # them beside the process group's flags (ported since the worker slice)
    # and name only --sp
    pytest.param(["generate", "--elastic", "--pod-devices", "4", "--max-replicas", "2",
                  "--coordinator", "h:1", "--nproc", "2", "--sp", "2"], "--sp",
                 id="extra9---elastic, --pod-devices, --max-replicas"),
    pytest.param(["generate", "--stall-timeout", "5", "--checkpoint-interval", "1",
                  "--resume-policy", "never", "--elastic-interval", "1", "--scale-up-util",
                  "0.5", "--reshape-kv-low", "0.1", "--proc-id", "1", "--program", "batch",
                  "--sp", "2"],
                 "--sp",
                 id="extra10---stall-timeout, --checkpoint-interval, --resume-policy"),
    (["generate", "--dp", "2"], "--dp (outside serve-pod)"),
])
def test_unported_flags_exit_naming_them(model_files, extra, named):
    m, t = model_files
    r = run_port(extra + ["--model", m, "--tokenizer", t, "--device", "cpu"])
    assert r.returncode != 0
    assert "not yet ported" in r.stderr and named in r.stderr
    msg = r.stderr.split("not yet ported to dllama_tpu_torch: ", 1)[1].split(" (run", 1)[0]
    assert not set(msg.split(", ")) & (PORTED_SINCE | FLEET_FLAGS | LOAD_FLAGS
                                       | ELASTIC_FLAGS | GROUP_FLAGS), msg
    assert "mode 'worker'" not in msg


# flags the port carries since speculative decoding and profiling came over
PORTED_SINCE = {"--pld", "--spec", "--spec-k", "--draft-model", "--profile-split",
                "--profile-ops"}
# and since the legacy-magic files and dense loading came over
LOAD_FLAGS = {"--weights-float-type", "--dequantize"}
# and since the fleet came over (router, serve-pod, the robustness flags)
FLEET_FLAGS = {"--backends", "--probe-interval", "--eject-after", "--readmit-after",
               "--router-retries", "--upstream-timeout", "--stall-timeout",
               "--checkpoint-interval", "--resume-policy", "--supervise", "--respawn-max",
               "--respawn-window", "--io-timeout", "--drain-grace", "--step-timeout",
               "--numeric-checks", "--verify-weights"}
# and since the elastic pod came over
ELASTIC_FLAGS = {"--elastic", "--pod-devices", "--min-replicas", "--max-replicas",
                 "--elastic-interval", "--elastic-window", "--elastic-cooldown",
                 "--scale-up-util", "--scale-down-util", "--scale-up-queue",
                 "--reshape-kv-low"}
# and since the worker mode and the process group came over
GROUP_FLAGS = {"--coordinator", "--nproc", "--proc-id", "--program"}


def test_fleet_modes_and_flags_left_the_refusal_lists():
    """``router``, ``serve-pod`` and, since the worker slice, ``worker``
    left ``NOT_PORTED_MODES``, which is empty; the fleet's flags (with
    ``--dp``, for serve-pod), the loading flags, the elastic pod's and the
    process group's four left ``NOT_PORTED_FLAGS``, which is empty.  They
    parse with the JAX CLI's defaults; ``--program`` offers the JAX CLI's
    worker programs."""
    from dllama_tpu.cli import WORKER_PROGRAMS as JPROGRAMS, build_parser as jparser
    from dllama_tpu_torch import cli
    assert cli.NOT_PORTED_MODES == ()
    assert {"router", "serve-pod", "worker"} <= set(cli.MODES)
    assert not cli.NOT_PORTED_FLAGS
    assert set(cli.WORKER_PROGRAMS) == set(JPROGRAMS) == {"generate", "inference", "batch"}
    args = cli.build_parser().parse_args(["serve-pod"])
    jargs = jparser().parse_args(["serve-pod"])
    for flag in sorted(FLEET_FLAGS | LOAD_FLAGS | ELASTIC_FLAGS | GROUP_FLAGS | {"--dp"}):
        key = flag[2:].replace("-", "_")
        assert getattr(args, key) == getattr(jargs, key), flag
    assert cli.not_ported(cli.build_parser().parse_args(
        ["serve-pod", "--dp", "2", "--supervise", "--respawn-max", "2", "--stall-timeout",
         "3", "--checkpoint-interval", "0.5", "--step-timeout", "9", "--numeric-checks",
         "--verify-weights", "--io-timeout", "3", "--drain-grace", "1", "--elastic",
         "--pod-devices", "4", "--min-replicas", "1", "--max-replicas", "2",
         "--elastic-interval", "0.5", "--elastic-window", "3", "--elastic-cooldown", "5",
         "--scale-up-util", "0.9", "--scale-down-util", "0.1", "--scale-up-queue", "3",
         "--reshape-kv-low", "-1"])) == []
    assert cli.not_ported(cli.build_parser().parse_args(
        ["router", "--backends", "h:1,h:2", "--probe-interval", "0.5"])) == []


def test_elastic_flags_parse_and_build_the_policy_as_jax():
    """The elastic flags' types and defaults are the JAX CLI's, value for
    value, on the options a user sets too; the policy the supervised pod
    gives its controller is the one the JAX pod builds from the same argv
    at dp = 2 (``dllama_tpu/router/pod.py:533-541``): the default
    ``--max-replicas 0`` is clamped to ``--min-replicas`` on both."""
    from dllama_tpu.cli import build_parser as jparser
    from dllama_tpu.router.elastic import ElasticPolicy as JPolicy
    from dllama_tpu_torch import cli
    from dllama_tpu_torch.router import pod
    argv = ["serve-pod", "--elastic", "--pod-devices", "6", "--min-replicas", "2",
            "--max-replicas", "3", "--elastic-interval", "0.25", "--elastic-window", "4",
            "--elastic-cooldown", "7.5", "--scale-up-util", "0.7", "--scale-down-util", "0.2",
            "--scale-up-queue", "1.5", "--reshape-kv-low", "0.05"]
    policies = []
    for given in ([], argv[1:]):
        args = cli.build_parser().parse_args(["serve-pod", "--dp", "2", *given])
        jargs = jparser().parse_args(["serve-pod", "--dp", "2", *given])
        for flag in sorted(ELASTIC_FLAGS):
            key = flag[2:].replace("-", "_")
            got, want = getattr(args, key), getattr(jargs, key)
            assert (got, type(got)) == (want, type(want)), flag
        want = JPolicy(
            window=getattr(jargs, "elastic_window", 5),
            cooldown=getattr(jargs, "elastic_cooldown", 30.0),
            up_util=getattr(jargs, "scale_up_util", 0.85),
            down_util=getattr(jargs, "scale_down_util", 0.15),
            up_queue=getattr(jargs, "scale_up_queue", 2.0),
            kv_low=getattr(jargs, "reshape_kv_low", 0.08),
            min_replicas=getattr(jargs, "min_replicas", 1),
            max_replicas=getattr(jargs, "max_replicas", jargs.dp))
        got = pod.elastic_policy(args)
        fields = ("window", "cooldown", "up_util", "down_util", "up_queue", "kv_low",
                  "min_replicas", "max_replicas")
        assert {f: getattr(got, f) for f in fields} == {f: getattr(want, f) for f in fields}
        policies.append(got)
    assert (policies[0].min_replicas, policies[0].max_replicas) == (1, 1)
    assert (policies[1].min_replicas, policies[1].max_replicas) == (2, 3)


ELASTIC_POD = ["--model", "m.m", "--tokenizer", "t.t", "--port", "0"]


@pytest.mark.parametrize("extra", [
    ["--elastic"],                                                   # no --supervise
    ["--supervise", "--elastic", "--batch-slots", "2", "--kv-pages", "40"],  # no --handoff
    ["--supervise", "--elastic", "--handoff"],                       # no slots
    ["--supervise", "--elastic", "--handoff", "--batch-slots", "2", "--kv-pages", "40",
     "--dp", "2", "--pod-devices", "1"],                             # the boot shape
], ids=["without-supervise", "without-handoff", "without-slots", "pod-devices-short"])
def test_elastic_start_up_refusals_equal_jax(extra):
    """``--elastic`` without ``--supervise``, and the supervised pod's
    three start-up checks, exit before any child with JAX's messages."""
    from dllama_tpu.cli import build_parser as jparser
    from dllama_tpu.router import pod as jpod
    from dllama_tpu_torch import cli
    from dllama_tpu_torch.router import pod
    msgs = []
    for main, parser, dev in ((pod.main, cli.build_parser, ["--device", "cpu"]),
                              (jpod.main, jparser, [])):
        with pytest.raises(SystemExit) as e:
            main(parser().parse_args(["serve-pod", *ELASTIC_POD, *dev, *extra]))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert msgs[0].startswith("serve-pod: --")


def test_spec_and_profile_flags_are_accepted():
    """The speculation and profiling flags left ``NOT_PORTED_FLAGS`` and
    parse with the JAX CLI's defaults; a run that sets them is not
    refused."""
    from dllama_tpu_torch import cli
    assert not PORTED_SINCE & set(cli.NOT_PORTED_FLAGS)
    args = cli.build_parser().parse_args(["inference"])
    assert (args.pld, args.spec, args.spec_k, args.draft_model, args.profile_split,
            args.profile_ops) == (0, "off", 4, None, False, False)
    args = cli.build_parser().parse_args(
        ["generate", "--pld", "3", "--spec", "draft", "--spec-k", "2", "--draft-model", "d.m",
         "--profile-split", "--profile-ops"])
    assert cli.not_ported(args) == []
    assert (args.pld, args.spec, args.spec_k, args.draft_model) == (3, "draft", 2, "d.m")


def test_nthreads_is_accepted_and_ignored(model_files):
    """Reference command lines carry ``--nthreads``; the port takes it as
    the JAX CLI does and prints what it prints without it."""
    m, t = model_files
    args = ["generate", "--model", m, "--tokenizer", t, "--prompt", "hello",
            "--steps", "8", "--temperature", "0", "--device", "cpu"]
    plain = run_port(args)
    threads = run_port(args + ["--nthreads", "2"])
    assert plain.returncode == 0 and threads.returncode == 0, threads.stderr[-2000:]
    assert threads.stdout == plain.stdout


def test_q40_variant_other_than_classic_is_refused(model_files):
    """Every variant of the JAX package is ported (fma, folded and exact
    run: tests/test_torch_q40_variants.py); a name outside the four is
    refused before the model is read, with the JAX package's error."""
    m, t = model_files
    env = dict(os.environ, DLLAMA_Q40_VARIANT="fmaa",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-m", "dllama_tpu_torch", "generate", "--model", m,
                        "--tokenizer", t, "--prompt", "hi", "--device", "cpu"],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert ("DLLAMA_Q40_VARIANT: unknown q40 kernel variant 'fmaa' "
            "(expected classic | fma | folded | exact)") in r.stderr
    assert "not yet ported" not in r.stderr


def test_no_sched_overlap_is_accepted_and_reaches_the_scheduler(model_files):
    """``--no-sched-overlap`` (the JAX CLI's flag) is accepted by the CLI and
    the server, and turns the slot scheduler's overlapped pipeline off; the
    pipeline is on without it."""
    from dllama_tpu_torch import cli
    from dllama_tpu_torch.server import api
    args = cli.build_parser().parse_args(["generate", "--no-sched-overlap"])
    assert args.no_sched_overlap and cli.not_ported(args) == []
    m, t = model_files
    base = ["--model", m, "--tokenizer", t, "--device", "cpu", "--host", "127.0.0.1",
            "--port", "0", "--batch-slots", "2", "--kv-pages", "40", "--kv-page-size", "4"]
    for extra, overlap in (([], True), (["--no-sched-overlap"], False)):
        server = api.start(base + extra)
        try:
            assert server.state.scheduler.overlap is overlap
        finally:
            api.stop(server)


# the state-movement flags (snapshots, hand-off, QoS, KV tiering), each
# away from its default, and where it lands: (scheduler attribute, value) or
# (server state attribute, value)
STATE_FLAGS = [("--kv-reserve", "optimistic", "kv_reserve", "optimistic"),
               ("--spill-headroom", "8", "spill_headroom", 8),
               ("--kv-host-pool-mb", "2", "host_pool", 2 << 20),
               ("--no-preempt", None, "preempt", False),
               ("--preempt-age-ms", "250", "preempt_age_ms", 250.0),
               ("--preempt-cap", "1", "preempt_cap", 1),
               ("--preempt-spill-dir", "parked", "spill_dir", "parked"),
               ("--snapshot-dir", "snaps", "snapshot_dir", "snaps"),
               ("--handoff", None, "handoff", True),
               ("--handoff-ttl", "7.5", "handoff_records", 7.5)]


def test_state_movement_flags_are_accepted_and_reach_the_server(model_files, tmp_path):
    """The ten flags left the not-ported list: the CLI and the server
    accept them, and each reaches the slot scheduler or the server
    state."""
    from dllama_tpu_torch import cli
    from dllama_tpu_torch.server import api
    argv = []
    for flag, value, *_ in STATE_FLAGS:
        if value in ("parked", "snaps"):
            value = str(tmp_path / value)
        argv += [flag] if value is None else [flag, value]
    assert not set(f for f, *_ in STATE_FLAGS) & set(cli.NOT_PORTED_FLAGS)
    assert cli.not_ported(cli.build_parser().parse_args(["generate", *argv])) == []
    m, t = model_files
    server = api.start(["--model", m, "--tokenizer", t, "--device", "cpu", "--host",
                        "127.0.0.1", "--port", "0", "--batch-slots", "2", "--kv-pages", "40",
                        "--kv-page-size", "4", *argv])
    try:
        state, sched = server.state, server.state.scheduler
        for flag, _, attr, want in STATE_FLAGS:
            obj = state if hasattr(state, attr) else sched
            got = getattr(obj, attr)
            if attr == "host_pool":
                got = got.capacity_bytes
            elif attr == "handoff_records":
                got = got.ttl
            elif attr in ("spill_dir", "snapshot_dir"):
                got = os.path.basename(got)
            assert got == want, flag
    finally:
        api.stop(server)
    with pytest.raises(SystemExit, match="--handoff needs the paged scheduler"):
        api.build_state(api.parse_args(["--model", m, "--tokenizer", t, "--device", "cpu",
                                        "--handoff"]))


OBS_FLAGS = ["--log-format", "json", "--log-level", "debug", "--trace-buffer", "64",
             "--flight-buffer", "16", "--event-buffer", "32", "--event-log", "ev.jsonl",
             "--slo", "ttft_p95=1500ms,error_rate=0.5%"]


def test_observability_flags_are_accepted():
    """The observability flags and ``--kv-cache-dtype q8`` left the
    not-ported list: the CLI and the server accept them; a bad ``--slo``
    exits naming the objective, as the JAX CLI does."""
    from dllama_tpu_torch import cli
    from dllama_tpu_torch.server import api
    args = cli.build_parser().parse_args(["generate", "--kv-cache-dtype", "q8", *OBS_FLAGS])
    assert cli.not_ported(args) == []
    args = api.parse_args(["--kv-cache-dtype", "q8", *OBS_FLAGS])
    assert (args.log_format, args.trace_buffer, args.slo) == \
        ("json", 64, "ttft_p95=1500ms,error_rate=0.5%")
    bad = cli.build_parser().parse_args(["generate", "--slo", "bogus_p95=1s"])
    with pytest.raises(SystemExit, match="--slo: unknown SLO objective 'bogus_p95'"):
        cli.configure_obs(bad)


def test_server_runs_with_observability_flags(model_files, tmp_path):
    """The server configured by every observability flag, on the int8
    contiguous cache (the scheduler steps aside, the lockstep batch
    serves): the response echoes the request id, the flight ring holds
    the request, and /health has the SLO verdict."""
    import json
    import urllib.request

    from dllama_tpu_torch.obs import log as obs_log
    from dllama_tpu_torch.server import api
    m, t = model_files
    flags = [f if f != "ev.jsonl" else str(tmp_path / "ev.jsonl") for f in OBS_FLAGS]
    server = api.start(["--model", m, "--tokenizer", t, "--device", "cpu", "--host",
                        "127.0.0.1", "--port", "0", "--batch-slots", "2",
                        "--kv-cache-dtype", "q8", *flags])
    try:
        assert server.state.scheduler is None and server.state.batch_engine.cache.quantized
        base = f"http://127.0.0.1:{server.server_address[1]}"
        # interactive: never shed.  The --slo engine's first verdict judges
        # the process-global totals, which the test files that ran before
        # this one in its worker process may have filled with errors or
        # slow first tokens; a standard request would then be shed (429)
        req = urllib.request.Request(base + "/v1/completions", json.dumps(
            {"prompt": ["hi", "hello"], "max_tokens": 4, "temperature": 0}).encode(),
            headers={"X-Request-Id": "cli-obs-1", "X-Dllama-Priority": "interactive"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200 and r.headers["X-Request-Id"] == "cli-obs-1"
            assert len(json.loads(r.read())["choices"]) == 2
        with urllib.request.urlopen(base + "/debug/requests/cli-obs-1", timeout=60) as r:
            assert json.loads(r.read())["finish"] == "served"
        with urllib.request.urlopen(base + "/health", timeout=60) as r:
            slo = json.loads(r.read())["slo"]
        assert set(slo["objectives"]) == {"ttft_p95", "error_rate"}
    finally:
        api.stop(server)
        obs_log.configure("human", "info", force=True)


def test_cuda_request_without_cuda_fails(model_files):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    m, t = model_files
    r = run_port(["generate", "--model", m, "--tokenizer", t, "--prompt", "hi"])
    assert r.returncode != 0
    assert "torch.cuda.is_available() is False" in r.stderr


def test_port_never_imports_jax_or_dllama_tpu(model_files, tmp_path):
    """Import every module of the port, run its CLI (on a Q40 Llama and a
    Q80 Mixtral file, and a blocked-layout batch) and serve one request
    through its API server's slot scheduler, then look at sys.modules: no
    jax, no dllama_tpu."""
    m, t = model_files
    moe = str(tmp_path / "mixtral-q80.m")
    write_tiny_model(moe, arch=mfile.ARCH_MIXTRAL, ftype=quants.Q80, n_experts=4)
    code = f"""
import importlib, json, pkgutil, sys, urllib.request
import dllama_tpu_torch
for mod in pkgutil.walk_packages(dllama_tpu_torch.__path__, "dllama_tpu_torch."):
    if not mod.name.endswith("__main__"):
        importlib.import_module(mod.name)
for name in ("server.api", "runtime.scheduler", "runtime.pagepool", "runtime.stream",
             "tokenizer.chat", "tokenizer.eos", "server.backoff", "ops.q8",
             "obs.log", "obs.metrics", "obs.trace", "obs.events", "obs.flight",
             "obs.slo", "obs.dispatch", "runtime.snapshot", "runtime.kvtier",
             "io.integrity", "obs.cost", "runtime.spec", "runtime.profiling",
             "runtime.faults", "router.registry", "router.fleet", "router.service",
             "router.pod", "router.elastic", "parallel.distributed", "parallel.comm"):
    assert "dllama_tpu_torch." + name in sys.modules, name
from dllama_tpu_torch import cli
for model in ({m!r}, {moe!r}):
    cli.main(["generate", "--model", model, "--tokenizer", {t!r}, "--prompt", "hello",
              "--steps", "6", "--temperature", "0", "--device", "cpu"])
import os
os.environ["DLLAMA_Q40_LAYOUT"] = "blocked"
cli.main(["batch", "--model", {m!r}, "--tokenizer", {t!r}, "--prompt", "hello",
          "--steps", "6", "--temperature", "0", "--device", "cpu"])
del os.environ["DLLAMA_Q40_LAYOUT"]
from dllama_tpu_torch.server import api
srv = api.start(["--model", {m!r}, "--tokenizer", {t!r}, "--device", "cpu", "--port", "0",
                 "--host", "127.0.0.1", "--batch-slots", "2", "--kv-pages", "40",
                 "--kv-page-size", "4"])
req = urllib.request.Request(f"http://127.0.0.1:{{srv.server_address[1]}}/v1/completions",
                             json.dumps({{"prompt": "hi", "max_tokens": 4}}).encode())
assert urllib.request.urlopen(req, timeout=60).status == 200
base = f"http://127.0.0.1:{{srv.server_address[1]}}"
for path in ("/metrics", "/metrics?format=prometheus", "/debug/trace", "/debug/events",
             "/debug/requests", "/debug/timeline", "/health"):
    assert urllib.request.urlopen(base + path, timeout=60).status == 200, path
api.stop(srv)
from dllama_tpu_torch.router import pod
p = pod.start(cli.build_parser().parse_args(
    ["serve-pod", "--model", {m!r}, "--tokenizer", {t!r}, "--device", "cpu", "--dp", "2",
     "--host", "127.0.0.1", "--port", "0", "--batch-slots", "2", "--kv-pages", "40",
     "--kv-page-size", "4", "--probe-interval", "0.2"]))
req = urllib.request.Request(f"http://127.0.0.1:{{p.port}}/v1/completions",
                             json.dumps({{"prompt": "hi", "max_tokens": 4}}).encode())
assert urllib.request.urlopen(req, timeout=60).status == 200
p.stop()
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "dllama_tpu", "ml_dtypes"))
print("FOREIGN", bad)
"""
    env = cpu_env()
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.splitlines()[-1] == "FOREIGN []"


_FOREIGN_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|dllama_tpu|ml_dtypes)(?:\.|\s|$)", re.M)


def test_static_scan_finds_no_foreign_imports():
    """No file of the port (and none of the chip scripts) imports jax,
    dllama_tpu or ml_dtypes (bf16 snapshots carry raw words instead)."""
    files = [os.path.join(REPO, f)
             for f in ("chip_smoke.py", "chip_ab_serving.py", "chip_prefill_rounding.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    for new in ("runtime/snapshot.py", "runtime/kvtier.py", "io/integrity.py", "obs/cost.py",
                "runtime/spec.py", "runtime/profiling.py", "runtime/faults.py",
                "router/__init__.py", "router/__main__.py", "router/registry.py",
                "router/fleet.py", "router/service.py", "router/pod.py", "router/elastic.py",
                "parallel/distributed.py", "parallel/comm.py"):
        assert os.path.join(PORT, *new.split("/")) in files, new
    hits = []
    for f in files:
        with open(f, encoding="utf-8") as fh:
            hits += [f"{f}: {m.group(0).strip()}" for m in _FOREIGN_IMPORT.finditer(fh.read())]
    assert hits == []
