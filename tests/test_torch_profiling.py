"""``dllama_tpu_torch/runtime/profiling.py`` (``torch.profiler``) on the
CPU, beside the JAX package's ``runtime/profiling.py``:

* ``traced_op_times`` returns each op's self time over the traced calls
  (the CPU's; a card's kernels are timed on the chip);
* ``split_op_times`` / ``summarize_split`` / ``top_ops`` give JAX's
  numbers and return shapes on the same per-op table, and kernel 4's
  symbol (``tp_allreduce_kernel``) counts as collective;
* ``profile_decode_steps`` leaves the engine's position where it was;
* ``inference --profile-split`` / ``--profile-ops`` print the split and
  the top ops;
* ``POST /debug/profile`` answers 200 with the top ops and the split on a
  CPU server, clamps its query, and answers 503 while draining.
"""

import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from dllama_tpu.runtime import profiling as jprof
from dllama_tpu_torch.models import config as tconfig, params as tparams
from dllama_tpu_torch.runtime import profiling as tprof
from dllama_tpu_torch.runtime.engine import Engine
from dllama_tpu.models import config as jconfig, params as jparams
from fixtures import REPO, write_tiny_model, write_tiny_tokenizer

K4 = "void tp_allreduce_kernel<float>(Ranks, int, int, long long, int, int)"
TABLE = {"void gemv_kernel<(anonymous namespace)::Q4, 128>(...)": 3.0,
         "paged_attention_split": 1.25, K4: 0.5, "ncclDevKernel_AllReduce_Sum_f32": 0.25,
         "aten::mm": 2.0}
# the same times under the JAX package's HLO names (its classifier)
JAX_TABLE = {"fusion.3": 3.0, "dot.1": 1.25, "all-reduce.2": 0.5, "all-gather.4": 0.25,
             "copy.9": 2.0}


def test_traced_op_times_on_the_cpu():
    a = torch.randn(64, 64)

    def step():
        torch.mm(a, a).relu_()

    times = tprof.traced_op_times(step, steps=3, device="cpu")
    assert times and all(ms > 0 for ms in times.values())
    assert any("mm" in name for name in times)
    assert tprof.traced_op_times(lambda: None, steps=2, device="cpu") is None


@pytest.mark.parametrize("steps", [1, 3])
def test_split_and_top_ops_equal_jax(steps):
    assert tprof.split_op_times(TABLE) == (6.25, 0.75)
    assert tprof.split_op_times(TABLE) == jprof.split_op_times(JAX_TABLE)
    assert tprof.summarize_split(TABLE, steps) == jprof.summarize_split(JAX_TABLE, steps)
    mine, ref = tprof.top_ops(TABLE, 3, steps), jprof.top_ops(JAX_TABLE, 3, steps)
    assert [ms for _, ms in mine] == [ms for _, ms in ref]
    assert [op for op, _ in mine][0].startswith("void gemv_kernel")
    assert tprof.summarize_split({}, steps) == jprof.summarize_split({}, steps)


def test_profile_decode_steps_restores_the_position():
    cfg = tconfig.tiny_config(seq_len=32)
    jp = jparams.init_params(jconfig.tiny_config(seq_len=32), seed=1)
    eng = Engine(cfg, tparams.from_jax_params({k: np.asarray(v) for k, v in jp.items()}, cfg),
                 device="cpu")
    eng.prefill([1, 2, 3])
    times, how = tprof.profile_decode_steps(eng, 3)
    assert eng.pos == 3 and how == "eager steps" and times
    eng.pos = 30  # no room for the steps: the engine starts over
    times, _ = tprof.profile_decode_steps(eng, 3)
    assert eng.pos == 0 and times


@pytest.fixture(scope="module")
def model_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("prof")
    m, t = str(d / "tiny.m"), str(d / "tiny.t")
    write_tiny_model(m)
    write_tiny_tokenizer(t)
    return m, t


@pytest.mark.parametrize("flags,n_top", [(["--profile-split"], 5),
                                         (["--profile-ops"], 10)])
def test_inference_profile_flags(model_files, flags, n_top):
    m, t = model_files
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-m", "dllama_tpu_torch", "inference", "--model", m,
                        "--tokenizer", t, "--prompt", "hello", "--steps", "4",
                        "--temperature", "0", "--device", "cpu", *flags],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.splitlines()
    split = [ln for ln in lines if ln.startswith("Profiled decode step (eager steps")]
    assert len(split) == 1 and "compute" in split[0] and "collectives 0.000 ms" in split[0]
    tops = [ln for ln in lines if ln.startswith("  top op")]
    assert 1 <= len(tops) <= n_top
    assert lines[-1].startswith("💡 q8 launches:")


def _post(base, path):
    req = urllib.request.Request(base + path, data=b"{}", method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_debug_profile_answers_200_then_503_while_draining(model_files):
    from dllama_tpu_torch.server import api
    m, t = model_files
    srv = api.start(["--model", m, "--tokenizer", t, "--device", "cpu", "--port", "0",
                     "--host", "127.0.0.1", "--batch-slots", "2", "--kv-pages", "40",
                     "--kv-page-size", "4", "--temperature", "0"])
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        code, body = _post(base, "/debug/profile?steps=2&top=4")
        assert code == 200, body
        assert body["steps"] == 2 and body["devices"] == 1 and body["how"] == "eager steps"
        assert 1 <= len(body["ops"]) <= 4 and all(o["ms"] >= 0 for o in body["ops"])
        assert body["compute_ms"] > 0 and body["collective_ms"] == 0
        assert body["collective_pct"] == 0
        # the query is clamped as JAX's: steps 1..16, top 1..50
        code, body = _post(base, "/debug/profile?steps=99&top=0")
        assert code == 200 and body["steps"] == 16 and len(body["ops"]) == 1
        assert srv.state.engine.pos == 0
        srv.state.begin_drain(30.0)
        code, body = _post(base, "/debug/profile")
        assert code == 503 and "draining" in body["error"]
    finally:
        api.stop(srv)
