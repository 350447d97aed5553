"""The port's serve-pod (dllama_tpu_torch.router.pod) on the CPU.

* ``parse_pod_tp`` equals JAX's; the partition follows the port's rule
  (``cuda``: replica r on cards r·tp …; ``cuda:K``: every replica on card
  K; ``cpu``), and too few cards is refused.
* A supervised child gets ``CUDA_VISIBLE_DEVICES`` for its cards and an
  argv that runs ``dllama_tpu_torch.server.api`` with its ``--device``
  (and ``--workers`` at tp > 1) and the pod's serving flags.
* The ``Supervisor`` over fake children (a stand-in for ``Popen``, as
  tests/test_chaos.py drives trivial children) respawns a dead child,
  quarantines a crash loop, replaces a hung one (``reason="hung"``, armed
  only after a first healthy probe) and counts a raising ``pod.respawn``
  as a death — the same deaths, respawns and quarantines as JAX's
  supervisor over the same script.
* ``serve-pod --dp 2 --device cpu`` in process: one router port, both
  replicas serve, the federated ``/metrics`` labels them; and ``serve-pod
  --supervise --dp 1 --device cpu`` (this file's one child process)
  serves through its router.
"""

import itertools
import json
import os
import sys
import threading
import time
import urllib.request

import pytest

from dllama_tpu import quants
from dllama_tpu.obs import metrics as jmetrics
from dllama_tpu.router import pod as jpod
from dllama_tpu.runtime import faults as jfaults
from dllama_tpu_torch.cli import build_parser
from dllama_tpu_torch.obs import metrics as obs_metrics
from dllama_tpu_torch.router import pod
from dllama_tpu_torch.runtime import faults
from fixtures import REPO, write_tiny_model, write_tiny_tokenizer


@pytest.mark.parametrize("workers,n,dp", [
    (None, 8, 2), ("tpu:2", 8, 2), ("TPU:3", 0, 4), ("host:port", 8, 2), (None, 1, 2),
    ("tpu:0", 4, 1), ("tpu:x", 4, 1)])
def test_parse_pod_tp_equals_jax(workers, n, dp):
    def run(mod):
        try:
            return mod.parse_pod_tp(workers, n, dp)
        except SystemExit as e:
            return "exit", str(e)
    assert run(pod) == run(jpod)


def test_partition_follows_the_port_placement():
    assert pod.partition_devices("cuda", 2, 2, 4) == [("cuda:0", "cuda:1"),
                                                      ("cuda:2", "cuda:3")]
    assert pod.partition_devices("cuda", 2, 1, 3) == [("cuda:0",), ("cuda:1",)]
    assert pod.partition_devices("cuda:1", 3, 2, 2) == [("cuda:1", "cuda:1")] * 3
    assert pod.partition_devices("cpu", 2, 2, 0) == [("cpu", "cpu")] * 2
    for bad in (("cuda", 2, 2, 3), ("cuda:2", 1, 1, 2), ("tpu", 1, 1, 8)):
        with pytest.raises(SystemExit):
            pod.partition_devices(*bad)


def _args(*extra):
    return build_parser().parse_args(["serve-pod", "--model", "m.m", "--tokenizer", "t.t",
                                      *extra])


@pytest.mark.parametrize("devs,visible,device", [
    (("cuda:2",), "2", "cuda:0"), (("cuda:2", "cuda:3"), "2,3", "cuda"),
    (("cuda:0", "cuda:0"), "0", "cuda:0"), (("cpu",), None, "cpu")])
def test_child_env_and_argv(devs, visible, device):
    ordinals, child_dev = pod.child_placement(devs)
    assert child_dev == device
    env = pod._child_env({"PATH": "/bin", "CUDA_VISIBLE_DEVICES": "7"}, ordinals)
    assert env.get("CUDA_VISIBLE_DEVICES") == (visible or "7") and env["PATH"] == "/bin"
    args = _args("--batch-slots", "4", "--kv-pages", "64", "--handoff", "--step-timeout",
                 "5", "--numeric-checks", "--verify-weights", "--max-seq-len", "256")
    argv = pod._replica_argv(args, 4321, "/snap/r0", child_dev, len(devs))
    assert argv[:3] == [sys.executable, "-m", "dllama_tpu_torch.server.api"]
    assert argv[argv.index("--device") + 1] == device
    assert argv[argv.index("--port") + 1] == "4321"
    assert ("--workers" in argv) == (len(devs) > 1)
    for flag in ("--handoff", "--numeric-checks", "--verify-weights"):
        assert flag in argv
    assert argv[argv.index("--step-timeout") + 1] == "5.0"
    assert argv[argv.index("--snapshot-dir") + 1] == "/snap/r0"
    # the child parses them as the server does, and refuses nothing
    from dllama_tpu_torch.server import api
    child = api.parse_args(argv[3:])
    assert child.device == device and child.handoff and child.step_timeout == 5.0


# -- the supervisor over fake children ------------------------------------

class _FakeProc:
    """A stand-in for ``subprocess.Popen``: alive until killed, or dead
    at once when the class is told to crash; ``healthy`` is what a
    /health probe would say."""

    crash = False
    pids = itertools.count(1000)

    def __init__(self, argv, env=None):
        self.argv, self.env = argv, env
        self.pid = next(self.pids)
        self.returncode = 1 if _FakeProc.crash else None
        self.healthy = True

    def poll(self):
        return self.returncode

    def kill(self):
        if self.returncode is None:
            self.returncode = -9

    def terminate(self):
        if self.returncode is None:
            self.returncode = -15

    def wait(self, timeout=None):
        return self.returncode


def _wait(cond, timeout=10.0, msg="condition never held"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(msg)


def _script(mod, fmod, scenario, monkeypatch):
    """Run one failure scenario on ``mod``'s Supervisor; returns what it
    did: deaths in the window, quarantine, spawned pids, respawns
    counted by reason."""
    monkeypatch.setattr(mod.subprocess, "Popen", _FakeProc)
    monkeypatch.setattr(mod.Supervisor, "_probe",
                        lambda self, rep: rep.proc.returncode is None and rep.proc.healthy)
    metrics = obs_metrics if mod is pod else jmetrics
    rep = mod._Replica(0, 1, ["child"], {})
    kw = dict(respawn_max=2, respawn_window=30.0, hang_probes=2, poll_interval=0.01,
              probe_timeout=0.1)
    sup = mod.Supervisor([rep], **kw)
    before = {r: metrics.POD_RESPAWNS.get("0", r) for r in ("exit", "hung")}
    spawned = []
    _FakeProc.crash = scenario == "crash_loop"
    try:
        sup.start()
        if scenario == "death":
            first = rep.proc
            first.kill()
            _wait(lambda: rep.proc is not first and rep.proc is not None)
            spawned = [first.returncode, rep.proc.returncode]
        elif scenario == "crash_loop":
            _wait(lambda: rep.quarantined)
            time.sleep(0.1)  # terminal: no further deaths
        elif scenario == "hang":
            _wait(lambda: rep.ready)
            first = rep.proc
            first.healthy = False
            _wait(lambda: rep.proc is not first and rep.proc is not None)
            spawned = [first.returncode, rep.proc.returncode]
        elif scenario == "respawn_fault":
            with fmod.injected("pod.respawn=raise:RuntimeError"):
                rep.proc.kill()
                _wait(lambda: rep.quarantined)
    finally:
        _FakeProc.crash = False
        sup.stop()
    return (len(rep.deaths), rep.quarantined, spawned,
            {r: metrics.POD_RESPAWNS.get("0", r) - before[r] for r in before})


@pytest.mark.parametrize("scenario", ["death", "crash_loop", "hang", "respawn_fault"])
def test_supervisor_equals_jax(scenario, monkeypatch):
    got = _script(pod, faults, scenario, monkeypatch)
    want = _script(jpod, jfaults, scenario, monkeypatch)
    assert got == want
    deaths, quarantined, spawned, respawns = got
    expect = {
        "death": (1, False, [-9, None], {"exit": 1, "hung": 0}),
        "crash_loop": (3, True, [], {"exit": 2, "hung": 0}),
        "hang": (1, False, [-9, None], {"exit": 0, "hung": 1}),
        # the failed respawns are deaths too, and none is counted a respawn
        "respawn_fault": (3, True, [], {"exit": 0, "hung": 0}),
    }[scenario]
    assert got == expect


# -- the pod itself -------------------------------------------------------

@pytest.fixture(scope="module")
def model(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_pod")
    m, t = str(d / "tiny.m"), str(d / "tiny.t")
    write_tiny_model(m, ftype=quants.Q40)
    write_tiny_tokenizer(t)
    return m, t


POD = ["--temperature", "0", "--buffer-float-type", "f32", "--batch-slots", "2",
       "--kv-pages", "40", "--kv-page-size", "4", "--host", "127.0.0.1", "--port", "0",
       "--probe-interval", "0.2", "--device", "cpu"]


def _post(base, body, timeout=120):
    req = urllib.request.Request(base + "/v1/completions", json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=30) as r:
        return json.loads(r.read())


def test_serve_pod_in_process(model):
    m, t = model
    p = pod.start(_args("--model", m, "--tokenizer", t, "--dp", "2", "--handoff", *POD))
    base = f"http://127.0.0.1:{p.port}"
    try:
        health = _get(base, "/health")
        assert health["role"] == "router" and health["total"] == 2
        assert health["available"] == 2
        addrs = [f"127.0.0.1:{s.server_address[1]}" for s in p.servers]
        # the replicas share the weights, each with its own caches
        e0, e1 = (s.state.engine for s in p.servers)
        assert e0.params["wcls"].qpacked.data_ptr() == e1.params["wcls"].qpacked.data_ptr()
        assert e0.cache.k.data_ptr() != e1.cache.k.data_ptr()
        before = [obs_metrics.ROUTER_DISPATCH.get(a) for a in addrs]
        body = {"prompt": "hello", "max_tokens": 8, "temperature": 0}
        outs = []
        with faults.injected("engine.device_step=delay:0.02"):
            threads = [threading.Thread(target=lambda: outs.append(_post(base, body)))
                       for _ in range(6)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(120)
        assert len(outs) == 6 and len({o["choices"][0]["text"] for o in outs}) == 1
        assert outs[0]["choices"][0]["text"] == _post(f"http://{addrs[1]}", body)["choices"][0]["text"]
        served = [obs_metrics.ROUTER_DISPATCH.get(a) - b for a, b in zip(addrs, before)]
        assert sum(served) == 6 and min(served) >= 1, served
        fed = _get(base, "/metrics")
        assert set(addrs) <= set(fed["replicas"])
    finally:
        p.stop()


def test_serve_pod_supervised(model, monkeypatch):
    """The one child process of this file: a supervised replica of the
    port's server on the CPU, answering through the pod's router."""
    m, t = model
    monkeypatch.setenv("PYTHONPATH", REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    p = pod.start(_args("--model", m, "--tokenizer", t, "--supervise", "--dp", "1", *POD))
    base = f"http://127.0.0.1:{p.port}"
    try:
        (rep,) = p.supervisor.replicas
        assert rep.argv[:3] == [sys.executable, "-m", "dllama_tpu_torch.server.api"]
        assert rep.argv[rep.argv.index("--device") + 1] == "cpu"
        _wait(lambda: rep.ready, timeout=120, msg="the child never answered /health")
        _wait(lambda: _get(base, "/health")["available"] == 1, timeout=30)
        out = _post(base, {"prompt": "hello", "max_tokens": 6, "temperature": 0})
        assert out["choices"][0]["finish_reason"] in ("stop", "length")
        assert p.supervisor.replicas_up() == 1
    finally:
        p.stop()
    assert rep.proc.poll() is not None
