"""Targets of ``torch.multiprocessing.spawn`` for tests/test_torch_multihost.py:
each runs in a child process that joins a two-process gloo group through
``dllama_tpu_torch.parallel.distributed.init_distributed``, does its part
and saves what it saw for the parent to compare.  This module imports
nothing of the JAX package, so the children start fast."""

from __future__ import annotations

import os

import torch


def _join(proc: int, port: int):
    from dllama_tpu_torch.parallel import distributed
    distributed.init_distributed(f"127.0.0.1:{port}", 2, proc, max_retries=0)
    return distributed.current_group()


def allreduce_and_copies(proc: int, port: int, out_dir: str, seed: int) -> None:
    """Kernel 4's plain version across the group at tp = 2 and tp = 4
    (one and two ranks a process), every rank's partials made from one
    seed on both processes; the copies of the forward (gather to process
    0, all-gather, the broadcast from rank 0); and the agreement check
    over values that differ."""
    from dllama_tpu_torch.ops import q40
    from dllama_tpu_torch.parallel import comm
    from dllama_tpu_torch.parallel.mesh import make_mesh
    g = _join(proc, port)
    out = {}
    for tp, t, d in ((2, 3, 64), (4, 5, 102), (4, 1, 4096)):
        gen = torch.Generator().manual_seed(seed + tp + t)
        parts = [torch.randn((t, d), generator=gen)
                 * 10 ** (torch.rand((t, d), generator=gen) * 4 - 2) for _ in range(tp)]
        mesh = make_mesh(tp, "cpu", g)
        local = [parts[r] for r in mesh.ranks]
        q40.reset_counters()
        out[(tp, t, d)] = q40.tp_allreduce(local, mesh=mesh)
        c = q40.counters()
        assert (c["allreduce_plain_calls"], c["allreduce_gloo_calls"],
                c["allreduce_launches"]) == (1, 1, 0), c
    mesh = make_mesh(4, "cpu", g)
    local = [torch.full((2, 3), float(r)) for r in mesh.ranks]
    out["gather"] = comm.gather_to_root(mesh, local)
    out["all_gather"] = comm.all_gather(mesh, local)
    mine = [torch.tensor([[proc, 7]]), torch.tensor([[0.5 + proc]])]
    out["broadcast"] = comm.broadcast_from_root(mesh, mine)
    try:
        g.agree(("stream", proc), "a test value")
        out["agree"] = None
    except RuntimeError as e:
        out["agree"] = str(e)
    g.agree(("stream", 1), "an equal value")
    torch.save(out, os.path.join(out_dir, f"allreduce{proc}.pt"))


def engine_tp4(proc: int, port: int, out_dir: str, path: str) -> None:
    """A tp = 4 engine over the group (two ranks a process) on the
    params saved at ``path``: greedy tokens and the launch counters."""
    from dllama_tpu_torch.ops import q40
    from dllama_tpu_torch.parallel.mesh import make_mesh
    from dllama_tpu_torch.runtime.engine import Engine
    cfg, params, prompt = torch.load(path, weights_only=False)
    g = _join(proc, port)
    mesh = make_mesh(4, "cpu", g)
    eng = Engine(cfg, params, device="cpu", mesh=mesh)
    q40.reset_counters()
    toks = [t for t, _ in eng.generate_stream(prompt, len(prompt) + 10, temperature=0.0,
                                              chunk=4)]
    eng.check_agreement()
    torch.save({"tokens": toks, "counters": q40.counters(), "forwards": eng.forwards,
                "ranks": len(eng.params.ranks)},
               os.path.join(out_dir, f"engine{proc}.pt"))
