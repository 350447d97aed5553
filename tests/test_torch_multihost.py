"""The port's process group on the CPU (gloo): ``worker`` mode and the
``--coordinator/--nproc/--proc-id/--program`` flags, one process a rank
group, against the port's single-process ``--workers tpu:N`` run and the
JAX package's single-process tp = N run of the same command (the port of
``tests/test_multihost.py``, ``tests/test_cli.py:100,147``).

Two processes on the tiny fixture model (``write_tiny_model``, as
tests/test_multihost.py writes it) run ``generate``/``batch`` with
``--buffer-float-type f32``: process 0's text must equal both golden runs
byte for byte (the ⚠️ lines of a leaf left replicated and the 💡 lines
aside), process 1 prints no stream, and both exit 0.  The kernel-4 plain
version across processes (gloo ``all_gather``, then the ring's adds) must
equal the one-process plain version bit for bit at tp = 2 and tp = 4 (two
ranks a process); a tp = 4 engine over two processes decodes the
single-process engine's greedy tokens.  Refusals name what they refuse; a
peer that never joins ends process 0 within the group's timeout.
"""

import os
import subprocess
import sys
import time

import pytest
import torch

from dllama_tpu import quants
from dllama_tpu.io import mfile
from fixtures import REPO, cpu_env, free_port, run_cli, write_tiny_model, write_tiny_tokenizer


def _port_env(extra: dict | None = None) -> dict:
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("DLLAMA_COORDINATOR", None)
    env.update(extra or {})
    return env


def _port(args, timeout=120, env=None) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", "dllama_tpu_torch", *args], cwd=REPO,
                          env=_port_env(env), capture_output=True, text=True,
                          timeout=timeout)


def _group(mode: str, args: list[str], timeout=180):
    """Process 1 as ``worker --program mode``, process 0 as ``mode``, both
    with ``args`` and their coordinates; returns (p0, p1) with p1's
    (stdout, stderr, returncode)."""
    coords = ["--coordinator", f"127.0.0.1:{free_port()}", "--nproc", "2"]
    p1 = subprocess.Popen([sys.executable, "-m", "dllama_tpu_torch", "worker", "--program",
                           mode, *args, *coords, "--proc-id", "1"], cwd=REPO,
                          env=_port_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                          text=True)
    try:
        p0 = _port([mode, *args, *coords, "--proc-id", "0"], timeout=timeout)
        out1, err1 = p1.communicate(timeout=timeout)
    finally:
        if p1.poll() is None:
            p1.kill()
    return p0, (out1, err1, p1.returncode)


def _text(stdout: str) -> list[str]:
    """The lines a run's text is held by: no 💡/⚠️ lines, no throughput."""
    return [ln for ln in stdout.splitlines()
            if not ln.startswith(("💡", "⚠️", "Batched", "[Gloo]"))]


def _counters(stderr: str) -> dict:
    import json
    lines = [ln for ln in stderr.splitlines() if ln.startswith('{"process"')]
    assert len(lines) == 1, stderr[-2000:]
    return json.loads(lines[0])


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_multihost")
    paths = {"f32": str(d / "toy.m"), "q80": str(d / "q80.m"), "mixtral": str(d / "mix.m"),
             "t128": str(d / "toy.t"), "t": str(d / "tiny.t")}
    write_tiny_model(paths["f32"], ftype=quants.F32, vocab_size=128, seq_len=64)
    write_tiny_tokenizer(paths["t128"], vocab_size=128)
    write_tiny_model(paths["q80"], ftype=quants.Q80)
    write_tiny_model(paths["mixtral"], arch=mfile.ARCH_MIXTRAL, ftype=quants.Q40,
                     n_experts=4)
    write_tiny_tokenizer(paths["t"])
    prompts = str(d / "prompts.txt")
    with open(prompts, "w") as f:
        f.write("hello hi\nonce upon\n")
    paths["prompts"] = prompts
    return paths


def _generate_args(files) -> list[str]:
    return ["--model", files["f32"], "--tokenizer", files["t128"], "--prompt", "hello hi",
            "--steps", "20", "--temperature", "0", "--seed", "1", "--buffer-float-type",
            "f32", "--chunk", "8", "--workers", "tpu:2"]


def test_nproc2_generate_matches_single_process_and_jax(files):
    args = _generate_args(files)
    p0, (out1, err1, rc1) = _group("generate", args + ["--device", "cpu"])
    assert p0.returncode == 0, p0.stderr[-2000:]
    assert rc1 == 0, err1[-2000:]
    # only process 0 owns the stream
    assert out1 == "" and "<s>" not in err1
    single = _port(["generate", *args, "--device", "cpu"])
    assert single.returncode == 0, single.stderr[-2000:]
    ref = run_cli(["generate", *args], n_devices=2)
    assert ref.returncode == 0, ref.stderr[-2000:]
    golden = ref.stdout.splitlines()[-1]
    assert golden.startswith("<s>hello hi"), golden
    assert _text(p0.stdout) == _text(single.stdout) == [golden]
    # process 0's launch line counts the plain all-reduce across processes
    last = p0.stdout.splitlines()[-1]
    assert " allreduce_ipc=0 allreduce_gloo=" in last and " nproc=2 " in last
    c0, c1 = _counters(p0.stderr), _counters(err1)
    assert (c0["process"], c1["process"], c0["nproc"]) == (0, 1, 2)
    assert c0["forwards"] == c1["forwards"] > 0
    # each process: 2 all-reduces a layer of the 2-layer model, every one plain
    assert c0["q40"]["allreduce_gloo_calls"] == c1["q40"]["allreduce_gloo_calls"] \
        == 2 * 2 * c0["forwards"]


def test_nproc2_ragged_batch_matches_single_process_and_jax(files):
    args = ["--model", files["f32"], "--tokenizer", files["t128"], "--prompts-file",
            files["prompts"], "--steps", "16", "--temperature", "0", "--seed", "1",
            "--buffer-float-type", "f32", "--chunk", "8", "--workers", "tpu:2"]
    p0, (out1, err1, rc1) = _group("batch", args + ["--device", "cpu"])
    assert p0.returncode == 0, p0.stderr[-2000:]
    assert rc1 == 0, err1[-2000:]
    assert "▶ stream" not in out1 + err1
    single = _port(["batch", *args, "--device", "cpu"])
    ref = run_cli(["batch", *args], n_devices=2)
    assert ref.returncode == 0, ref.stderr[-2000:]
    golden = [ln for ln in _text(ref.stdout) if not ln.startswith("Generated")]
    assert "▶ stream 1" in golden
    got = [ln for ln in _text(p0.stdout) if not ln.startswith("Generated")]
    assert got == golden
    assert _text(p0.stdout) == _text(single.stdout)


@pytest.mark.parametrize("name", ["q80", "mixtral"])
def test_nproc2_quantized_and_moe_match_single_process_and_jax(files, name):
    """A Q80 file (w2 left replicated at tp = 2: its input gathered across
    the processes) and a Mixtral file (the routing chosen on rank 0 and
    broadcast; the experts' down replicated) at nproc = 2."""
    args = ["--model", files[name], "--tokenizer", files["t"], "--prompt", "hello",
            "--steps", "24", "--temperature", "0", "--buffer-float-type", "f32",
            "--workers", "tpu:2"]
    p0, (out1, err1, rc1) = _group("generate", args + ["--device", "cpu"])
    assert p0.returncode == 0, p0.stderr[-2000:]
    assert rc1 == 0, err1[-2000:]
    assert out1 == ""
    single = _port(["generate", *args, "--device", "cpu"])
    ref = run_cli(["generate", *args], n_devices=2)
    assert ref.returncode == 0, ref.stderr[-2000:]
    ours = _text(p0.stdout)
    assert ours == _text(single.stdout) == _text(ref.stdout)
    assert len(ours[0]) > len("<s>hello")


def test_worker_joins_single_process_group(files):
    """``worker`` at nproc = 1 joins a group of one and runs the mirrored
    program: the plain ``generate``'s text."""
    args = _generate_args(files)[:-2] + ["--device", "cpu"]
    r = _port(["worker", "--coordinator", f"127.0.0.1:{free_port()}", "--nproc", "1",
               "--proc-id", "0", "--program", "generate", *args])
    assert r.returncode == 0, r.stderr[-2000:]
    plain = _port(["generate", *args])
    assert _text(r.stdout) == _text(plain.stdout) and len(_text(r.stdout)[0]) > 8


def test_worker_without_coordinates_explains_the_mapping():
    r = _port(["worker"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "--workers tpu:N" in r.stdout and "--coordinator host:port" in r.stdout
    assert "cuda:K" in r.stdout


@pytest.mark.parametrize("extra,named", [
    (["generate", "--workers", "tpu:3", "--nproc", "2", "--proc-id", "0"],
     "valid tp for 2 processes: [2, 4, 6, 8]"),
    (["generate", "--workers", "tpu:2", "--nproc", "2"], "--proc-id is required"),
    (["chat", "--workers", "tpu:2", "--nproc", "2", "--proc-id", "0"],
     "mode 'chat' does not run over a process group"),
    (["serve-pod", "--nproc", "1", "--proc-id", "0"],
     "mode 'serve-pod' does not run over a process group"),
    (["generate", "--pld", "4", "--nproc", "1", "--proc-id", "0"],
     "--pld is not yet ported over a process group"),
], ids=["tp-split", "no-proc-id", "chat", "serve-pod", "pld"])
def test_refusals_name_what_they_refuse(files, extra, named):
    r = _port([*extra, "--coordinator", f"127.0.0.1:{free_port()}", "--model", files["f32"],
               "--tokenizer", files["t128"], "--prompt", "hi", "--device", "cpu"], timeout=60)
    assert r.returncode != 0
    assert named in r.stderr, r.stderr[-2000:]


def test_server_refuses_coordinates():
    from dllama_tpu_torch.server import api
    with pytest.raises(SystemExit, match="does not run over a process group"):
        api.parse_args(["--coordinator", "127.0.0.1:1", "--nproc", "2", "--proc-id", "0"])


def test_a_peer_that_never_joins_ends_process_0(files):
    """Process 0 alone in a group of two: the rendezvous times out after
    the group's timeout (DLLAMA_GROUP_TIMEOUT) and the process exits
    non-zero; it does not hang."""
    args = _generate_args(files) + ["--device", "cpu", "--coordinator",
                                    f"127.0.0.1:{free_port()}", "--nproc", "2",
                                    "--proc-id", "0"]
    t0 = time.monotonic()
    r = _port(["generate", *args], timeout=90,
              env={"DLLAMA_GROUP_TIMEOUT": "3", "DLLAMA_INIT_RETRIES": "0"})
    took = time.monotonic() - t0
    assert r.returncode != 0
    assert took < 60, took
    assert "<s>" not in r.stdout


def _spawn(fn, *args):
    import torch.multiprocessing as mp
    mp.spawn(fn, args=(free_port(), *args), nprocs=2, join=True)


def test_group_plain_allreduce_and_copies_equal_one_process(tmp_path):
    """Kernel 4's plain version across two processes (tp = 2: a rank each;
    tp = 4: two ranks each) equals the one-process plain version on every
    rank, bit for bit; the forward's copies land in rank order; the
    agreement check raises on both processes when they disagree."""
    from dllama_tpu_torch.ops import q40
    import torch_group_workers as w
    _spawn(w.allreduce_and_copies, str(tmp_path), 5)
    outs = [torch.load(tmp_path / f"allreduce{p}.pt") for p in (0, 1)]
    for tp, t, d in ((2, 3, 64), (4, 5, 102), (4, 1, 4096)):
        gen = torch.Generator().manual_seed(5 + tp + t)
        parts = [torch.randn((t, d), generator=gen)
                 * 10 ** (torch.rand((t, d), generator=gen) * 4 - 2) for _ in range(tp)]
        want = q40.tp_allreduce_plain(parts)
        got = outs[0][(tp, t, d)] + outs[1][(tp, t, d)]
        assert len(got) == tp
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    every = [torch.full((2, 3), float(r)) for r in range(4)]
    assert outs[1]["gather"] is None
    for got in (outs[0]["gather"], outs[0]["all_gather"], outs[1]["all_gather"]):
        assert len(got) == 4 and all(torch.equal(a, b) for a, b in zip(got, every))
    for o in outs:
        idx, wts = o["broadcast"]
        assert torch.equal(idx, torch.tensor([[0, 7]])) and torch.equal(wts, torch.tensor([[0.5]]))
        assert o["agree"] is not None and "disagree on a test value" in o["agree"]


def test_engine_tp4_over_two_processes_decodes_the_single_process_tokens(tmp_path):
    """A tp = 4 Q40 engine (hidden 128, 4 kv heads) over two processes of
    two ranks each: the greedy tokens of the single-process tp = 4
    engine.  wo (64 rows: not whole 32-row blocks a rank at tp = 4) stays
    replicated, so its input is gathered across the processes; w2 is
    summed by the plain all-reduce across them."""
    from dllama_tpu_torch.models import config as tconfig, params as tparams
    from dllama_tpu_torch.ops import q40
    from dllama_tpu_torch.parallel.mesh import make_mesh
    from dllama_tpu_torch.runtime.engine import Engine
    import torch_group_workers as w
    cfg = tconfig.tiny_config(hidden_dim=128, n_kv_heads=4)
    params = tparams.quantize_matmuls(tparams.init_params(cfg, seed=3), cfg, q40)
    prompt = [3, 14, 15, 92, 6, 5, 35]
    torch.save((cfg, params, prompt), tmp_path / "model.pt")
    _spawn(w.engine_tp4, str(tmp_path), str(tmp_path / "model.pt"))
    one = Engine(cfg, params, device="cpu", mesh=make_mesh(4, "cpu"))
    want = [t for t, _ in one.generate_stream(prompt, len(prompt) + 10, temperature=0.0,
                                              chunk=4)]
    for p in (0, 1):
        got = torch.load(tmp_path / f"engine{p}.pt")
        assert got["tokens"] == want and got["ranks"] == 2
        # 2 layers x w2 a forward, every all-reduce across the processes
        assert got["counters"]["allreduce_gloo_calls"] == 2 * got["forwards"]


# --- the loader and the mesh --------------------------------------------------

@pytest.mark.parametrize("name", ["f32", "q80", "mixtral", "q40"])
def test_load_placed_equals_place_params(files, tmp_path, name):
    """Each process's ranks read from the file (packed planes: only their
    bytes) equal ``place_params`` of the whole file's params, bit for bit,
    with the same leaves left replicated."""
    from dllama_tpu_torch.io import mfile as tmfile
    from dllama_tpu_torch.models import params as tparams
    from dllama_tpu_torch.models.config import ModelConfig
    from dllama_tpu_torch.parallel import sharding
    from dllama_tpu_torch.parallel.mesh import Mesh
    path = files.get(name)
    if name == "q40":
        path = str(tmp_path / "q40.m")
        write_tiny_model(path, ftype=quants.Q40)
    with tmfile.MFile(path) as mf:
        cfg = ModelConfig.from_spec(mf.spec, dtype=torch.float32)
        _, whole = tparams.load_params(mf, cfg, fuse=False)
        for proc in (0, 1):
            mesh = Mesh((torch.device("cpu"),), 2, proc)
            a = tparams.load_placed(mf, cfg, mesh)
            b = sharding.place_params(whole, cfg, mesh)
            assert a.kinds == b.kinds
            for ra, rb in zip(a.ranks, b.ranks):
                assert set(ra) == set(rb)
                for k, vb in rb.items():
                    va = ra[k]
                    if hasattr(vb, "qpacked"):
                        assert va.logical_nd == vb.logical_nd, k
                        assert torch.equal(va.qpacked, vb.qpacked), k
                        assert torch.equal(va.scales, vb.scales), k
                    else:
                        assert torch.equal(va, vb), k


class _FakeGroup:
    def __init__(self, index, count, hosts=None):
        self.index, self.count = index, count
        self._hosts = hosts or ["h"] * count

    def hosts(self):
        return self._hosts


def test_mesh_places_each_process_ranks(monkeypatch):
    from dllama_tpu_torch.parallel.mesh import make_mesh
    m = make_mesh(4, "cpu", _FakeGroup(1, 2))
    assert (m.tp, m.nproc, m.proc, list(m.ranks), m.multi) == (4, 2, 1, [2, 3], True)
    assert m.devices == (torch.device("cpu"),) * 2
    m = make_mesh(2, "cuda:0", _FakeGroup(1, 2))
    assert m.devices == (torch.device("cuda", 0),) and m.rank0 == 1
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    m = make_mesh(4, "cuda", _FakeGroup(1, 2))
    assert m.devices == (torch.device("cuda", 2), torch.device("cuda", 3))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)  # one host of 2 cards each
    assert make_mesh(4, "cuda", _FakeGroup(1, 2)).devices == \
        (torch.device("cuda", 0), torch.device("cuda", 1))
    with pytest.raises(ValueError, match=r"valid tp for 2 processes: \[2, 4, 6, 8\]"):
        make_mesh(3, "cpu", _FakeGroup(0, 2))
    # one process: the single-process mesh
    assert make_mesh(2, "cpu").devices == (torch.device("cpu"),) * 2


def test_cuda_group_across_hosts_is_refused():
    from dllama_tpu_torch.parallel.mesh import make_mesh
    with pytest.raises(ValueError, match="spans hosts .*CUDA IPC.*not yet ported"):
        make_mesh(2, "cuda:0", _FakeGroup(0, 2, ["a", "b"]))
    # gloo crosses hosts: a CPU group across hosts is taken
    assert make_mesh(2, "cpu", _FakeGroup(0, 2, ["a", "b"])).tp == 2


def test_engine_reserves_its_largest_forward_for_the_region():
    """An engine over a group reserves batch × seq_len rows (× the active
    experts of a MoE model) for kernel 4's communication region."""
    from dllama_tpu_torch.models import config as tconfig, params as tparams
    from dllama_tpu_torch.parallel.distributed import Group
    from dllama_tpu_torch.parallel.mesh import Mesh
    from dllama_tpu_torch.runtime.engine import Engine
    cfg = tconfig.tiny_config(n_kv_heads=2)
    params = tparams.init_params(cfg, seed=1)
    g = Group(0, 2)
    Engine(cfg, params, device="cpu", mesh=Mesh((torch.device("cpu"),), 2, 0, g), batch=3,
           seq_len=40)
    assert g.max_rows == 3 * 40
    moe = tconfig.tiny_config(n_kv_heads=2, n_experts=4, n_active_experts=2,
                              arch=mfile.ARCH_MIXTRAL)
    Engine(moe, tparams.init_params(moe, seed=1), device="cpu",
           mesh=Mesh((torch.device("cpu"),), 2, 0, g), batch=1, seq_len=64)
    assert g.max_rows == 64 * 2


def test_bind_declares_the_cross_process_entry_points():
    """Every pointer and the stream of the cross-process entry points cross
    ctypes as c_void_p (64-bit); the capacity and the wait bound as 64-bit
    ints, the generation as an unsigned one."""
    import ctypes

    from dllama_tpu_torch.parallel import comm

    class Fake:
        pass

    names = ("tp_allreduce_ipc", "tp_ipc_alloc", "tp_ipc_open", "tp_ipc_close", "tp_ipc_free",
             "tp_ipc_handle_bytes", "tp_copy")
    lib = Fake()
    for n in names:
        setattr(lib, n, type(n, (), {})())
    comm.bind(lib)
    vp, pp = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
    argt = lib.tp_allreduce_ipc.argtypes
    assert argt[:3] == [pp] * 3 and argt[-1] is vp
    assert argt[6] is ctypes.c_longlong and argt[10:12] == [ctypes.c_uint, ctypes.c_longlong]
    assert lib.tp_copy.argtypes == [vp, vp, ctypes.c_longlong, vp]
    assert lib.tp_ipc_close.argtypes == lib.tp_ipc_free.argtypes == [vp]
    assert all(getattr(lib, n).restype is ctypes.c_int for n in names)
