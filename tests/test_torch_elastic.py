"""The port's elastic pod (dllama_tpu_torch.router.elastic, and pod.py's
side of it) against the JAX package's.

* Each unit test of tests/test_elastic.py has a counterpart here that runs
  the same scenario on both packages and holds the port to JAX: the
  device pool's allocations and errors, the policy's decisions over the
  same sample windows, the registry's runtime membership, and the
  controller over the same in-memory registry and replica fakes (the same
  op log, registry rows, pool, ``fleet_status`` and metric deltas).
* The supervisor's runtime add/remove, its held-port fence, and its
  refusal to respawn a ``retiring`` child run over trivial sleeper
  children, on both packages.
* The port's ordinal rule: ``_PodOps.spawn`` places a child on its cards
  under ``--device cuda``, on card K under ``cuda:K`` (``--workers`` at
  tp > 1) and on the CPU; ``_PodOps.retire`` marks the child retiring
  before its SIGTERM.
* ``/admin/scale`` and ``/admin/reshape`` answer as JAX's router does:
  404 without a controller, 400 on a bad argument, 202 and the command.
* The drill: ``serve-pod --supervise --elastic --device cpu`` on the tiny
  Q40 model scales 1 → 2 → 1 with greedy streams migrated off the retired
  child, and reshapes 2×tp=1 → 2×tp=2 with a stream in flight; every
  stream's text equals the JAX engine's greedy text for its prompt.
"""

import json
import os
import socket
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from types import SimpleNamespace

import pytest

from dllama_tpu import quants
from dllama_tpu.obs import metrics as jmetrics
from dllama_tpu.router import elastic as jelastic, pod as jpod, registry as jregistry
from dllama_tpu.router import service as jservice
from dllama_tpu_torch.cli import build_parser
from dllama_tpu_torch.obs import metrics as tmetrics
from dllama_tpu_torch.router import elastic, pod, registry, service
from fixtures import REPO, free_port, write_tiny_model, write_tiny_tokenizer

pytestmark = pytest.mark.elastic

_SLEEPER = [sys.executable, "-c", "import time; time.sleep(600)"]
# (elastic module, pod module, registry module, metrics module) a package
PACKAGES = {"port": (elastic, pod, registry, tmetrics),
            "jax": (jelastic, jpod, jregistry, jmetrics)}


def _both(scenario):
    """``scenario`` run on the port's classes and on JAX's; asserts the
    results equal and returns the port's."""
    got = scenario(*PACKAGES["port"])
    want = scenario(*PACKAGES["jax"])
    assert got == want
    return got


def _outcome(fn, *a):
    try:
        return fn(*a)
    except ValueError as e:
        return ("ValueError", str(e))


def _wait(cond, timeout=30.0, msg="condition never held"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(msg)


# -- device pool ----------------------------------------------------------

def test_device_pool_contiguous_then_fragmented_equals_jax():
    def run(el, *_):
        pool = el.DevicePool(8)
        a, b, c = pool.allocate(2), pool.allocate(2), pool.allocate(2)
        pool.release(b)                  # hole at 2,3
        d = pool.allocate(4)             # no contiguous 4-run left
        return a, b, c, d, pool.free
    assert _both(run) == ([0, 1], [2, 3], [4, 5], [2, 3, 6, 7], 0)


def test_device_pool_exhaustion_and_double_release_equals_jax():
    def run(el, *_):
        pool = el.DevicePool(2)
        got = pool.allocate(2)
        out = [got, _outcome(pool.allocate, 1), _outcome(pool.allocate, 0)]
        pool.release(got)
        out += [_outcome(pool.release, [0]), _outcome(pool.release, [99]),
                _outcome(el.DevicePool, 0)]
        return out
    out = _both(run)
    assert out[0] == [0, 1]
    assert all(o[0] == "ValueError" for o in out[1:])


# -- policy (pure signal-window decisions) --------------------------------

def _hot(util=0.95, q=5.0, kv=0.5):
    return {"util": util, "queue_per_replica": q, "kv_free_frac": kv}


def _cold(util=0.05, q=0.0, kv=0.9):
    return {"util": util, "queue_per_replica": q, "kv_free_frac": kv}


def _policy(el, **kw):
    return el.ElasticPolicy(**{**dict(window=3, cooldown=10.0, min_replicas=1,
                                      max_replicas=4), **kw})


def _d(d):
    return None if d is None else (d.direction, d.reason, d.tp)


def test_policy_needs_full_window_equals_jax():
    def run(el, *_):
        p = _policy(el)
        p.observe(_hot())
        p.observe(_hot())
        early = _d(p.decide(0.0, n_replicas=1, tp=1, free_devices=3))
        p.observe(_hot())
        return early, _d(p.decide(0.0, n_replicas=1, tp=1, free_devices=3))
    assert _both(run) == (None, ("up", "load", None))


def test_policy_hysteresis_one_cool_sample_blocks_equals_jax():
    def run(el, *_):
        p = _policy(el)
        for s in (_hot(), {"util": 0.5, "queue_per_replica": 0.0, "kv_free_frac": 0.5},
                  _hot()):
            p.observe(s)
        return _d(p.decide(0.0, n_replicas=1, tp=1, free_devices=3))
    assert _both(run) is None


def test_policy_cooldown_blocks_and_clears_window_equals_jax():
    def run(el, *_):
        p = _policy(el)
        for _ in range(3):
            p.observe(_hot())
        out = [_d(p.decide(100.0, n_replicas=1, tp=1, free_devices=3))]
        p.note_action(100.0)
        for _ in range(3):
            p.observe(_hot())
        out += [_d(p.decide(t, n_replicas=1, tp=1, free_devices=3)) for t in (105.0, 111.0)]
        p2 = _policy(el)
        for _ in range(3):
            p2.observe(_hot())
        p2.note_action(0.0)
        return out + [_d(p2.decide(50.0, n_replicas=1, tp=1, free_devices=3))]
    assert _both(run) == [("up", "load", None), None, ("up", "load", None), None]


def test_policy_scale_down_and_min_floor_equals_jax():
    def run(el, *_):
        p = _policy(el, min_replicas=2)
        for _ in range(3):
            p.observe(_cold())
        out = [_d(p.decide(0.0, n_replicas=3, tp=1, free_devices=1))]
        for _ in range(3):
            p.observe(_cold())
        return out + [_d(p.decide(0.0, n_replicas=2, tp=1, free_devices=2))]
    assert _both(run) == [("down", "idle", None), None]


def test_policy_up_capped_at_max_equals_jax():
    def run(el, *_):
        p = _policy(el, max_replicas=2)
        for _ in range(3):
            p.observe(_hot())
        return _d(p.decide(0.0, n_replicas=2, tp=1, free_devices=2))
    assert _both(run) is None


def test_policy_reshape_narrower_when_devices_exhausted_equals_jax():
    def run(el, *_):
        p = _policy(el)
        for _ in range(3):
            p.observe(_hot())
        out = [_d(p.decide(0.0, n_replicas=2, tp=2, free_devices=0))]
        for _ in range(3):
            p.observe(_hot())
        return out + [_d(p.decide(0.0, n_replicas=4, tp=1, free_devices=0))]
    assert _both(run) == [("reshape", "load", 1), None]


def test_policy_reshape_wider_on_kv_starvation_equals_jax():
    def run(el, *_):
        p = _policy(el)
        for _ in range(3):
            p.observe(_hot(kv=0.01))
        out = [_d(p.decide(0.0, n_replicas=4, tp=1, free_devices=0))]
        p2 = _policy(el, min_replicas=2)
        for _ in range(3):
            p2.observe(_hot(kv=0.01))
        return out + [_d(p2.decide(0.0, n_replicas=2, tp=1, free_devices=0))]
    assert _both(run) == [("reshape", "kv_pressure", 2), None]


# -- registry runtime membership ------------------------------------------

def _registry(reg_mod, n=2):
    reg = reg_mod.Registry([f"127.0.0.1:{10000 + i}" for i in range(n)],
                           probe_interval=999.0)
    for b in reg.backends:
        b.last_health = {"status": "ok", "capacity": {"free_slots": 2}}
    return reg


def test_registry_runtime_add_gated_until_first_probe_equals_jax():
    def run(el, pd, reg_mod, _):
        reg = _registry(reg_mod)
        b = reg.add("127.0.0.1:10099")
        out = [reg.get("127.0.0.1:10099") is b,
               any(reg.pick() is b for _ in range(4)), reg.snapshot()["available"]]
        b.last_health = {"status": "ok", "capacity": {"free_slots": 99}}
        out += [reg.pick() is b, reg.snapshot()["available"],
                _outcome(reg.add, "127.0.0.1:10099")[0]]
        return out
    assert _both(run) == [True, False, 2, True, 3, "ValueError"]


def test_registry_retire_fences_dispatch_not_export_equals_jax():
    def run(el, pd, reg_mod, _):
        reg = _registry(reg_mod)
        victim = reg.backends[0]
        reg.retire(victim.addr)
        snap = reg.snapshot()
        row = [r for r in snap["backends"] if r["addr"] == victim.addr][0]
        return (any(reg.pick() is victim for _ in range(4)),
                victim in reg.handoff_peers(), snap["available"], row["retiring"],
                row["ejected"])
    assert _both(run) == (False, False, 1, True, False)


def test_registry_remove_runtime_equals_jax():
    def run(el, pd, reg_mod, _):
        reg = _registry(reg_mod)
        gone = reg.backends[0].addr
        return (reg.remove(gone) is not None, reg.get(gone), reg.snapshot()["total"],
                reg.remove("127.0.0.1:59999"))
    assert _both(run) == (True, None, 1, None)


# -- controller over fakes ------------------------------------------------

class FakeRegistry:
    """Registry seam the controller needs: membership + admission."""

    def __init__(self, ports=()):
        self.rows = {}
        for p in ports:
            self.add(f"127.0.0.1:{p}")

    def add(self, addr):
        if addr in self.rows:
            raise ValueError(addr)
        self.rows[addr] = SimpleNamespace(addr=addr, last_health={"status": "ok"},
                                          ejected=False, retiring=False)

    def remove(self, addr):
        return self.rows.pop(addr, None)

    def retire(self, addr):
        if addr in self.rows:
            self.rows[addr].retiring = True

    def get(self, addr):
        return self.rows.get(addr)

    def score(self, b):
        return 0.0

    def eligible_backends(self):
        return []


class FakeOps:
    """Replica mechanics without processes; ``log`` is every spawn and
    retire in order."""

    def __init__(self, *, tp=1, n=2):
        self.reps = [self._mk(i, tp, [i]) for i in range(n)]
        self._next = n
        self.retired = []
        self.log = []

    @staticmethod
    def _mk(idx, tp, ordinals):
        return SimpleNamespace(idx=idx, port=9000 + idx, tp=tp, ordinals=list(ordinals),
                               retiring=False, quarantined=False)

    def spawn(self, tp, ordinals):
        rep = self._mk(self._next, tp, ordinals)
        self._next += 1
        self.reps.append(rep)
        self.log.append(("spawn", rep.idx, tp, list(ordinals)))
        return rep

    def retire(self, rep, *, grace):
        rep.retiring = True
        self.reps.remove(rep)
        self.retired.append(rep)
        self.log.append(("retire", rep.idx, rep.tp, list(rep.ordinals)))

    def live_replicas(self):
        return [r for r in self.reps if not r.quarantined]

    def reap_quarantined(self):
        out = [r for r in self.reps if r.quarantined]
        for r in out:
            self.reps.remove(r)
        return out


SCALE_LABELS = [(d, r) for d in ("up", "down", "reshape") for r in ("manual", "quarantined")]


def _controller(el, *, tp=1, n=2, pool_total=4, min_replicas=1, max_replicas=4):
    ops = FakeOps(tp=tp, n=n)
    reg = FakeRegistry(r.port for r in ops.reps)
    pool = el.DevicePool(pool_total)
    for r in ops.reps:                   # seat the boot shape
        r.ordinals = pool.allocate(tp)
    policy = el.ElasticPolicy(window=3, cooldown=0.0, min_replicas=min_replicas,
                              max_replicas=max_replicas)
    ctl = el.ElasticController(ops, reg, pool, policy, tp=tp, interval=0.01,
                               drain_grace=0.1, boot_timeout=2.0)
    return ctl, ops, reg, pool


def _state(ctl, ops, reg, pool, metrics, before):
    """What a controller scenario leaves behind: the op log, the live
    shape, the registry rows, the pool, the metric deltas."""
    return dict(log=list(ops.log), live=[(r.idx, r.tp, r.ordinals) for r in ops.live_replicas()],
                rows=sorted(reg.rows), free=pool.free, tp=ctl.tp,
                desired=metrics.POD_REPLICAS_DESIRED.value,
                events={k: metrics.POD_SCALE_EVENTS.get(*k) - before[k] for k in SCALE_LABELS})


def _scenario(body, **kw):
    def run(el, pd, reg_mod, metrics):
        before = {k: metrics.POD_SCALE_EVENTS.get(*k) for k in SCALE_LABELS}
        ctl, ops, reg, pool = _controller(el, **kw)
        out = body(ctl, ops, reg, pool)
        return out, _state(ctl, ops, reg, pool, metrics, before)
    return _both(run)


def test_controller_manual_scale_up_and_down_equals_jax():
    def body(ctl, ops, reg, pool):
        ctl.request_scale(4)
        ctl._tick()                      # the controller thread's step
        mid = (len(ops.live_replicas()), pool.free, len(reg.rows))
        ctl.request_scale(2)
        ctl._tick()
        return mid, len(ops.retired)
    (mid, retired), st = _scenario(body, n=2, pool_total=4)
    assert mid == (4, 0, 4) and retired == 2
    assert len(st["live"]) == 2 and st["free"] == 2 and len(st["rows"]) == 2
    assert st["events"][("up", "manual")] == 2 and st["events"][("down", "manual")] == 2


def test_controller_scale_clamps_to_bounds_equals_jax():
    def body(ctl, ops, reg, pool):
        ctl.request_scale(99)
        ctl._tick()
        n = len(ops.live_replicas())
        ctl.request_scale(0)
        ctl._tick()
        return n, len(ops.live_replicas())
    out, _ = _scenario(body, n=2, pool_total=4, min_replicas=2, max_replicas=3)
    assert out == (3, 2)


def test_controller_scale_up_blocked_without_devices_equals_jax():
    def body(ctl, ops, reg, pool):
        ctl.request_scale(4)
        ctl._tick()                      # pool empty: no spawn, no crash
        return len(ops.live_replicas())
    out, st = _scenario(body, n=2, pool_total=2)
    assert out == 2 and st["log"] == []


def test_controller_reshape_narrow_to_wide_and_back_equals_jax():
    """4×tp=1 → 2×tp=2 over a full 4-device pool (it must retire before it
    can spawn), then back: the same interleave of spawns and retires."""
    def body(ctl, ops, reg, pool):
        ctl.request_reshape(2)
        ctl._tick()
        wide = ([r.tp for r in ops.live_replicas()], pool.free, len(reg.rows), ctl.tp)
        ctl.request_reshape(1)
        ctl._tick()
        return wide
    wide, st = _scenario(body, tp=1, n=4, pool_total=4)
    assert wide == ([2, 2], 0, 2, 2)
    assert st["tp"] == 1 and [r[1] for r in st["live"]] == [1, 1, 1, 1]
    assert st["free"] == 0 and len(st["rows"]) == 4
    assert st["events"][("reshape", "manual")] == 2
    assert st["log"][:3] == [("retire", 0, 1, [0]), ("retire", 1, 1, [1]),
                             ("spawn", 4, 2, [0, 1])]


def test_controller_reshape_rejects_oversized_tp_equals_jax():
    def body(ctl, ops, reg, pool):
        return [_outcome(ctl.request_reshape, 8), _outcome(ctl.request_reshape, 0),
                ctl.request_reshape(2), ctl.request_scale(3)]
    out, _ = _scenario(body, tp=1, n=2, pool_total=4)
    assert out[0][0] == out[1][0] == "ValueError"
    assert out[2:] == [{"accepted": True, "target_tp": 2},
                       {"accepted": True, "target_replicas": 3}]


def test_controller_reaps_quarantined_replica_equals_jax():
    def body(ctl, ops, reg, pool):
        victim = ops.reps[1]
        victim.quarantined = True
        ctl._tick()
        return victim in ops.reps, f"127.0.0.1:{victim.port}" in reg.rows, pool.free
    out, st = _scenario(body, n=3, pool_total=4)
    assert out == (False, False, 2)      # 1 spare + the reclaimed seat
    assert st["events"][("down", "quarantined")] == 1


def test_controller_never_retires_last_replica_equals_jax():
    def body(ctl, ops, reg, pool):
        return ctl._retire_one("test"), len(ops.live_replicas())
    out, _ = _scenario(body, n=1, pool_total=2)
    assert out == (False, 1)


def test_controller_fleet_status_shape_equals_jax():
    def body(ctl, ops, reg, pool):
        return ctl.fleet_status()
    fs, _ = _scenario(body, tp=1, n=2, pool_total=4)
    assert fs["elastic"] is True and fs["tp"] == 1
    assert fs["n_replicas"] == 2 and fs["busy"] is None
    assert fs["device_pool"] == {"total": 4, "free": 2}
    assert [r["tp"] for r in fs["replicas"]] == [1, 1]


def test_controller_samples_registry_health_equals_jax():
    """``_sample`` reads the registry's cached ``/health`` blocks: the same
    fleet signal from the same blocks (slots, queue, effective free KV)."""
    healths = [
        {"scheduler": {"slots": 4, "active": 4, "kv_pages_total": 40},
         "capacity": {"queue_depth": 3, "kv_pressure": {"effective_free": 2}}},
        {"scheduler": {"slots": 4, "active": 1, "kv_pages_total": 40,
                       "kv_pages_free": 30}, "capacity": {"queue_depth": 0}},
        {"max_pending": 8, "in_flight": 2},
    ]

    def run(el, pd, reg_mod, _):
        reg = reg_mod.Registry([f"127.0.0.1:{p}" for p in (1, 2, 3)], probe_interval=999.0)
        for b, h in zip(reg.backends, healths):
            b.last_health = dict(h, status="ok")
        ctl, *_ = _controller(el)
        ctl.registry = reg
        return ctl._sample()
    s = _both(run)
    assert s == {"util": 7 / 16, "queue_per_replica": 1.0, "kv_free_frac": 32 / 80}


# -- port-hold fence + supervisor runtime membership ----------------------

def test_hold_port_fences_the_bind_race():
    """While the allocation socket is held nobody can steal the port;
    ``Supervisor.spawn`` releases it in the instant before the child
    starts (the port's supervisor, as JAX's test holds JAX's)."""
    port, held = pod._hold_port()
    thief = socket.socket()
    try:
        with pytest.raises(OSError):
            thief.bind(("127.0.0.1", port))
    finally:
        thief.close()
    rep = pod._Replica(0, port, list(_SLEEPER), dict(os.environ), sock=held)
    sup = pod.Supervisor([rep], poll_interval=0.05, probe_timeout=0.5)
    sup.spawn(rep)
    try:
        assert rep.sock is None and held.fileno() == -1
        reclaim = socket.socket()
        try:
            reclaim.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            reclaim.bind(("127.0.0.1", port))
        finally:
            reclaim.close()
    finally:
        rep.proc.kill()
        rep.proc.wait(timeout=10)


def test_supervisor_runtime_add_remove_equals_jax():
    def run(el, pd, *_):
        rep0 = pd._Replica(0, free_port(), list(_SLEEPER), dict(os.environ))
        sup = pd.Supervisor([rep0], poll_interval=0.05, probe_timeout=0.5)
        sup.start()
        try:
            rep1 = pd._Replica(1, free_port(), list(_SLEEPER), dict(os.environ), tp=2,
                               ordinals=[2, 3])
            sup.add(rep1)
            out = [rep1.proc.poll(), sup.replicas_up(), rep1.tp, rep1.ordinals]
            rep1.retiring = True
            rep1.proc.kill()
            rep1.proc.wait(timeout=10)
            sup.remove(rep1)
            sup.remove(rep1)             # twice: a no-op
            return out + [sup.replicas_up(), len(sup.snapshot())]
        finally:
            sup.stop()
    assert _both(run) == [None, 2, 2, [2, 3], 1, 1]


def test_supervisor_skips_retiring_replica_death_equals_jax():
    """A retiring replica's exit is drain completion, not a death: no
    respawn, no crash-loop accounting — in the watch loop and in
    ``_died`` itself (the port's ``_died`` returns at once for it)."""
    def run(el, pd, *_):
        rep = pd._Replica(0, free_port(), list(_SLEEPER), dict(os.environ))
        sup = pd.Supervisor([rep], poll_interval=0.05, probe_timeout=0.5)
        sup.start()
        try:
            _wait(lambda: rep.proc is not None and rep.proc.poll() is None)
            rep.retiring = True
            pid = rep.proc.pid
            rep.proc.kill()
            rep.proc.wait(timeout=10)
            time.sleep(0.3)              # several watch-loop passes
            return rep.proc.pid == pid, len(rep.deaths), rep.quarantined
        finally:
            sup.stop()
    assert _both(run) == (True, 0, False)
    rep = pod._Replica(0, 1, ["child"], {})
    rep.retiring = True
    pod.Supervisor([rep])._died(rep, "exit")
    assert len(rep.deaths) == 0 and rep.proc is None


def test_a_retire_begun_during_a_death_wins_over_the_respawn(monkeypatch):
    """The controller may mark a replica retiring while the watch loop is
    inside ``_died`` for it (a SIGKILLed old child during a reshape): the
    respawn re-checks under the lock ``begin_retire`` takes, so no child is
    spawned that nobody would stop."""
    spawned = []
    rep = pod._Replica(0, 1, ["child"], {})
    sup = pod.Supervisor([rep])
    monkeypatch.setattr(sup, "spawn", spawned.append)
    emit = pod.obs_events.emit

    def retire_midway(kind, **kw):
        emit(kind, **kw)
        if kind == "death":
            assert sup.begin_retire(rep) is None
    monkeypatch.setattr(pod.obs_events, "emit", retire_midway)
    sup._died(rep, "exit")
    assert spawned == [] and rep.retiring and len(rep.deaths) == 1


# -- the port's ordinal rule and _PodOps ----------------------------------

class _FakeSup:
    def __init__(self):
        self.replicas = []

    def begin_retire(self, rep):
        rep.retiring = True
        return rep.proc

    def add(self, rep):
        self.replicas.append(rep)

    def remove(self, rep):
        self.replicas.remove(rep)

    def snapshot(self):
        return list(self.replicas)


def _pod_args(*extra):
    return build_parser().parse_args(["serve-pod", "--model", "m.m", "--tokenizer", "t.t",
                                      "--batch-slots", "2", "--kv-pages", "40", "--handoff",
                                      *extra])


@pytest.mark.parametrize("device,tp,ordinals,visible,child_dev", [
    ("cuda", 1, [2], "2", "cuda:0"), ("cuda", 2, [2, 3], "2,3", "cuda"),
    ("cuda:1", 1, [3], "1", "cuda:0"), ("cuda:0", 2, [2, 3], "0", "cuda:0"),
    ("cpu", 2, [0, 1], None, "cpu")])
def test_pod_ops_spawn_places_by_the_ordinal_rule(device, tp, ordinals, visible, child_dev):
    """Under ``cuda`` the ordinals are the child's cards; under ``cuda:K``
    every child runs on card K and under ``cpu`` on the CPU (the ordinals
    are bookkeeping); ``--workers tpu:2`` at tp = 2."""
    assert pod.ordinal_devices(device, ordinals) == (
        tuple(f"cuda:{o}" for o in ordinals) if device == "cuda" else (device,) * tp)
    sup = _FakeSup()
    ops = pod._PodOps(sup, _pod_args("--device", device))
    rep = ops.spawn(tp, ordinals)
    try:
        assert sup.replicas == [rep] and (rep.idx, rep.tp, rep.ordinals) == (0, tp, ordinals)
        assert rep.env.get("CUDA_VISIBLE_DEVICES") == (
            visible or os.environ.get("CUDA_VISIBLE_DEVICES"))
        argv = rep.argv
        assert argv[:3] == [sys.executable, "-m", "dllama_tpu_torch.server.api"]
        assert argv[argv.index("--device") + 1] == child_dev
        assert argv[argv.index("--port") + 1] == str(rep.port)
        assert ("--workers" in argv) == (tp > 1)
        if tp > 1:
            assert argv[argv.index("--workers") + 1] == f"tpu:{tp}"
        assert ops.spawn(tp, ordinals).idx == 1
    finally:
        for r in sup.replicas:
            r.sock.close()


def test_pod_ops_retire_marks_retiring_before_sigterm():
    class Proc:
        def __init__(self):
            self.code, self.seen = None, None

        def poll(self):
            return self.code

        def terminate(self):
            self.seen = rep.retiring
            self.code = -15

        def wait(self, timeout=None):
            return self.code

    sup = _FakeSup()
    rep = pod._Replica(0, 1, ["child"], {}, tp=1, ordinals=[0])
    rep.proc = Proc()
    sup.add(rep)
    pod._PodOps(sup, _pod_args()).retire(rep, grace=0.1)
    assert rep.proc.seen is True and rep.retiring and sup.replicas == []


def test_pod_devices_above_the_cards_are_refused(monkeypatch):
    """Under ``--device cuda`` an ordinal is a card: a budget above the
    cards present is refused at start, before any build or child."""
    monkeypatch.setattr(pod, "_card_count", lambda device: 2)
    args = _pod_args("--supervise", "--elastic", "--device", "cuda", "--workers", "tpu:1",
                     "--pod-devices", "4")
    with pytest.raises(SystemExit, match=r"--pod-devices 4 needs 4 cards, only 2 present"):
        pod.build(args)


# -- the admin surface ----------------------------------------------------

def _admin(svc, reg_mod, el, with_controller: bool):
    reg = reg_mod.Registry(["127.0.0.1:1"], probe_interval=999.0)
    state = svc.RouterState(reg)
    if with_controller:
        ctl, *_ = _controller(el, n=2, pool_total=4, max_replicas=3)
        state.elastic = ctl
    # the handler alone (JAX's ``serve`` blocks): no probe thread
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), svc.make_handler(state))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    out = []
    for path in ("/admin/scale?n=3", "/admin/scale?n=99", "/admin/scale", "/admin/scale?n=x",
                 "/admin/reshape?tp=2", "/admin/reshape?tp=9", "/admin/reshape?tp=0",
                 "/admin/reshape"):
        req = urllib.request.Request(base + path, b"{}", method="POST")
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                out.append((r.status, json.loads(r.read())))
        except urllib.error.HTTPError as e:
            out.append((e.code, json.loads(e.read())))
    if with_controller:
        with urllib.request.urlopen(base + "/health", timeout=30) as r:
            out.append(json.loads(r.read())["fleet"])
    httpd.shutdown()
    httpd.server_close()
    return out


@pytest.mark.parametrize("with_controller", [False, True])
def test_admin_scale_and_reshape_answer_as_jax(with_controller):
    got = _admin(service, registry, elastic, with_controller)
    want = _admin(jservice, jregistry, jelastic, with_controller)
    assert got == want
    if not with_controller:
        assert {c for c, _ in got} == {404}
        assert got[0][1]["error"] == ("this router has no elastic controller "
                                      "(run serve-pod --supervise --elastic)")
        return
    codes = [c for c, _ in got[:8]]
    assert codes == [202, 202, 400, 400, 202, 400, 400, 400]
    assert got[0][1] == {"accepted": True, "target_replicas": 3}
    assert got[1][1] == {"accepted": True, "target_replicas": 3}   # clamped to max
    assert got[4][1] == {"accepted": True, "target_tp": 2}
    assert got[8]["elastic"] is True and got[8]["device_pool"] == {"total": 4, "free": 2}


# -- the drill: a supervised elastic pod of child processes on the CPU ----

PROMPT = "hello"
# a scale-down's streams (its retire comes at once) and the reshape's (its
# first retire waits for a child's boot): the old children's bursts of 16
# tokens are slowed, so each stream is still on them when it comes
SHORT, LONG = 100, 400


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_elastic")
    m, t = str(d / "tiny.m"), str(d / "tiny.t")
    write_tiny_model(m, ftype=quants.Q40, seq_len=512)
    write_tiny_tokenizer(t)
    return m, t


def _jax_greedy_texts(m: str, t: str) -> dict:
    """The JAX engine's greedy completions of PROMPT (SHORT and LONG
    tokens), through
    the JAX server on the same files, built as tests/test_torch_api.py
    builds it (its slot scheduler on a paged pool, one device)."""
    from dllama_tpu.cli import build_parser as jparser, load_stack
    from dllama_tpu.runtime.engine import Engine as JEngine
    from dllama_tpu.runtime.scheduler import SlotScheduler as JScheduler
    from dllama_tpu.server import api as japi
    args = jparser().parse_args(["inference", "--model", m, "--tokenizer", t, "--workers",
                                 "tpu:1", "--buffer-float-type", "f32"])
    engine, tok = load_stack(args)
    batch = JEngine(engine.cfg, engine.params, mesh=engine.mesh, batch=2,
                    kv_dtype=engine.cache.k.dtype, kv_pages=260, kv_page_size=4)
    sched = JScheduler(batch, overlap=True)
    srv = japi.serve(japi.ApiState(engine, tok, default_temperature=0.0, batch_engine=batch,
                                   scheduler=sched), host="127.0.0.1", port=0, block=False)
    try:
        return {n: _complete(f"http://127.0.0.1:{srv.server_address[1]}", n)
                for n in (SHORT, LONG)}
    finally:
        srv.shutdown()
        srv.server_close()
        sched.close()


def _complete(base: str, n: int) -> str:
    req = urllib.request.Request(
        base + "/v1/completions",
        json.dumps({"prompt": PROMPT, "max_tokens": n, "temperature": 0}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())["choices"][0]["text"]


class _Stream:
    """One greedy SSE completion of PROMPT (``n`` tokens) on a thread."""

    def __init__(self, base: str, n: int):
        self.text, self.fins, self.error = "", [], None
        self._req = urllib.request.Request(
            base + "/v1/completions",
            json.dumps({"prompt": PROMPT, "max_tokens": n, "temperature": 0,
                        "stream": True}).encode(),
            headers={"Content-Type": "application/json"})
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        try:
            with urllib.request.urlopen(self._req, timeout=300) as r:
                for line in r:
                    line = line.decode().strip()
                    if line.startswith("data: {"):
                        ch = json.loads(line[6:])["choices"][0]
                        self.text += ch.get("text") or ""
                        if ch.get("finish_reason"):
                            self.fins.append(ch["finish_reason"])
        except Exception as e:  # noqa: BLE001 — re-raised on join
            self.error = e

    def join(self) -> str:
        self.thread.join(300)
        assert not self.thread.is_alive() and self.error is None, self.error
        assert self.fins[-1:] in (["length"], ["stop"]), self.fins
        return self.text


def _post(base: str, path: str) -> dict:
    req = urllib.request.Request(base + path, b"{}", method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        assert r.status == 202
        return json.loads(r.read())


def test_elastic_pod_drill_on_the_cpu(model, monkeypatch):
    """Scale 1 → 2 → 1 with greedy streams on both children (the retired
    one's migrate over the hand-off wire), then back to 2 and a live
    reshape to 2×tp=2 with a stream in flight.  Each stream's text is the
    JAX engine's; the retired children are not respawned and their
    ordinals return to the pool."""
    m, t = model
    want = _jax_greedy_texts(m, t)
    assert len(want[SHORT]) > 20 and len(want[LONG]) > len(want[SHORT])
    monkeypatch.setenv("PYTHONPATH", REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    # the tp = 1 children's steps are slowed (the faults module arms at
    # import, in each child: this process is not affected)
    monkeypatch.setenv("DLLAMA_FAULTS", "engine.device_step=delay:0.5")
    args = build_parser().parse_args([
        "serve-pod", "--model", m, "--tokenizer", t, "--supervise", "--elastic",
        "--device", "cpu", "--dp", "1", "--pod-devices", "4", "--min-replicas", "1",
        "--max-replicas", "2", "--handoff", "--temperature", "0", "--buffer-float-type",
        "f32", "--batch-slots", "4", "--kv-pages", "520", "--kv-page-size", "4",
        "--host", "127.0.0.1", "--port", "0", "--probe-interval", "0.2",
        "--readmit-after", "1", "--elastic-interval", "0.2",
        # the policy neutered: only the /admin commands act
        "--scale-up-util", "2", "--scale-down-util", "-1", "--scale-up-queue", "1000000",
        "--reshape-kv-low", "-1"])
    p = pod.start(args)
    base = f"http://127.0.0.1:{p.port}"
    ctl, reg, sup = p.rstate.elastic, p.rstate.registry, p.supervisor

    def fleet():
        with urllib.request.urlopen(base + "/health", timeout=30) as r:
            return json.loads(r.read())

    def settled(n, tp):
        f = fleet()
        return (f["available"] == n and f["fleet"]["busy"] is None
                and f["fleet"]["n_replicas"] == n
                and all(r["tp"] == tp and not r["retiring"] for r in f["fleet"]["replicas"]))

    try:
        _wait(lambda: settled(1, 1), 120, "the first child")
        handoffs = tmetrics.ROUTER_HANDOFFS.value
        events = {k: tmetrics.POD_SCALE_EVENTS.get(*k)
                  for k in (("up", "manual"), ("down", "manual"), ("reshape", "manual"))}
        # scale up: a second child on the pool's next ordinal, admitted
        assert _post(base, "/admin/scale?n=2") == {"accepted": True, "target_replicas": 2}
        _wait(lambda: settled(2, 1), 120, "the second child")
        assert sorted(r.ordinals for r in sup.snapshot()) == [[0], [1]]
        # scale down with a stream on each child: the victim's migrates
        streams = [_Stream(base, SHORT) for _ in range(2)]
        _wait(lambda: all(s.text for s in streams), 60, "the streams' first chunks")
        before = {r.idx: r for r in sup.snapshot()}
        assert _post(base, "/admin/scale?n=1") == {"accepted": True, "target_replicas": 1}
        assert [s.join() for s in streams] == [want[SHORT]] * 2
        _wait(lambda: settled(1, 1), 60, "the scale-down")
        (victim,) = [r for i, r in before.items() if i not in {x.idx for x in sup.snapshot()}]
        assert victim.retiring and victim.proc.poll() is not None
        assert tmetrics.ROUTER_HANDOFFS.value > handoffs
        assert ctl.pool.free == 3 and tmetrics.POD_REPLICAS_DESIRED.value == 1
        # reshape 2×tp=1 → 2×tp=2 with a stream in flight
        _post(base, "/admin/scale?n=2")
        _wait(lambda: settled(2, 1), 120, "the second child again")
        stream = _Stream(base, LONG)
        _wait(lambda: stream.text, 60, "the stream's first chunk")
        handoffs = tmetrics.ROUTER_HANDOFFS.value
        monkeypatch.delenv("DLLAMA_FAULTS")      # the tp = 2 children run at speed
        assert _post(base, "/admin/reshape?tp=2") == {"accepted": True, "target_tp": 2}
        assert stream.join() == want[LONG]
        # the stream rode a retired tp = 1 child: it moved over the wire
        assert stream.fins == ["length"] and tmetrics.ROUTER_HANDOFFS.value > handoffs
        _wait(lambda: settled(2, 2), 180, "the reshape")
        assert ctl.tp == 2 and ctl.pool.free == 0
        assert tmetrics.POD_REPLICAS_DESIRED.value == 2
        assert sorted(r.ordinals for r in sup.snapshot()) == [[0, 1], [2, 3]]
        for rep in sup.snapshot():
            assert rep.argv[rep.argv.index("--workers") + 1] == "tpu:2"
        assert _complete(base, SHORT) == want[SHORT]
        got = {k: tmetrics.POD_SCALE_EVENTS.get(*k) - v for k, v in events.items()}
        assert got == {("up", "manual"): 4, ("down", "manual"): 3, ("reshape", "manual"): 1}
    finally:
        p.stop()
    assert all(r.proc.poll() is not None for r in sup.snapshot())
