"""The cross-process collectives of the tensor-parallel forward, over a
mesh that spans processes (``parallel/mesh.py``; one process a rank group,
``parallel/distributed.py``).

Besides kernel 4 (``ops/q40.py`` ``tp_allreduce``), the forward moves
three things between ranks, none of which computes anything:

* :func:`gather_to_root` — the vocab-sliced logits of every rank, in rank
  order, to process 0, which samples (``models/transformer.py``
  ``_head_tp``); the other processes gather nothing;
* :func:`broadcast_from_root` — the MoE routing (``top_idx``, weights)
  chosen on global rank 0, to every process (``_moe_ffn_tp``): at tp >= 3
  the ranks' residual streams differ in the last bits, so a process that
  routed on its own rank could pick other experts;
* :func:`all_gather` — every rank's slice of the input of a
  column-sliced weight that did not divide and stayed replicated
  (``_col_mm``).

On the CPU they are gloo collectives (``distributed.Group``).  On the card
they are copies from the peers' CUDA IPC regions (:class:`RankRegions`,
the same machinery kernel 4's cross-process body reads): each process
copies its ranks' tensors into its own regions, synchronizes, and a gloo
barrier says the bytes are in place; the readers copy from the mapped
regions, synchronize, and a second barrier says the regions may be
written again.  Every function is collective: each process calls it at
the same point with tensors of the same shapes.
"""

from __future__ import annotations

import ctypes

import torch

#: bytes ahead of a region's data: its flag word (csrc/tp_allreduce.cu kRegionHead)
REGION_HEAD = 256


def _lib():
    from ..ops import _build
    return _build.load()


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the cross-process entry points of ``csrc/tp_allreduce.cu``
    (every pointer and the stream as ``c_void_p``, so ctypes never cuts a
    64-bit pointer)."""
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # kernel 4 across processes: the partials, the outputs, every rank's
    # region; tp, the launched ranks, the region's capacity (f32), t, d, the
    # load width; the generation; the wait bound (ns); the stream
    lib.tp_allreduce_ipc.argtypes = [ctypes.POINTER(vp)] * 3 + [ci] * 3 + [ll] + [ci] * 3 + [
        ctypes.c_uint, ll, vp]
    lib.tp_allreduce_ipc.restype = ci
    lib.tp_ipc_alloc.argtypes = [ll, ctypes.POINTER(vp), ctypes.c_char_p]
    lib.tp_ipc_alloc.restype = ci
    lib.tp_ipc_open.argtypes = [ctypes.c_char_p, ctypes.POINTER(vp)]
    lib.tp_ipc_open.restype = ci
    for fn in (lib.tp_ipc_close, lib.tp_ipc_free):
        fn.argtypes = [vp]
        fn.restype = ci
    lib.tp_ipc_handle_bytes.argtypes = []
    lib.tp_ipc_handle_bytes.restype = ci
    lib.tp_copy.argtypes = [vp, vp, ll, vp]
    lib.tp_copy.restype = ci
    return lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc} "
                           f"({_lib().q40_error_string(rc).decode()})")


class RankRegions:
    """One CUDA IPC region of ``nbytes`` a global rank of ``mesh``: this
    process's ranks' allocated on their devices (``cudaMalloc``, outside
    PyTorch's caching allocator, zeroed), the peers' mapped into this
    process.  The handles cross the group once (``Group.exchange``); the
    constructor and :meth:`close` are collective.  ``base[r]`` is rank r's
    region as a pointer valid in this process."""

    def __init__(self, mesh, nbytes: int):
        lib = _lib()
        self.mesh, self.nbytes = mesh, int(nbytes)
        hb = lib.tp_ipc_handle_bytes()
        self.own, handles = [], []
        for dev in mesh.devices:
            ptr, h = ctypes.c_void_p(), (ctypes.c_char * hb)()
            with torch.cuda.device(dev):
                _check(lib.tp_ipc_alloc(self.nbytes, ctypes.byref(ptr), h),
                       f"allocating a {self.nbytes}-byte communication region on {dev}")
            self.own.append(ptr.value)
            handles.append(bytes(h))
        self.base, self.opened = [], []
        for k, hs in enumerate(mesh.group.exchange(handles)):
            for j, h in enumerate(hs):
                if k == mesh.proc:
                    self.base.append(self.own[j])
                    continue
                ptr = ctypes.c_void_p()
                with torch.cuda.device(mesh.device):
                    _check(lib.tp_ipc_open(h, ctypes.byref(ptr)),
                           f"mapping process {k}'s communication region")
                self.base.append(ptr.value)
                self.opened.append(ptr.value)
        #: kernel 4's call count over these regions (its generation)
        self.gen = 0

    def close(self) -> None:
        """Unmap the peers' regions, wait for every process to have done
        so, then free this process's."""
        lib = _lib()
        with torch.cuda.device(self.mesh.device):
            for p in self.opened:
                _check(lib.tp_ipc_close(ctypes.c_void_p(p)), "unmapping a peer region")
        self.mesh.group.barrier()
        for dev, p in zip(self.mesh.devices, self.own):
            with torch.cuda.device(dev):
                torch.cuda.synchronize(dev)
                _check(lib.tp_ipc_free(ctypes.c_void_p(p)), "freeing a region")
        self.opened, self.own, self.base = [], [], []


def staging(mesh, nbytes: int) -> RankRegions:
    """The group's staging regions, grown (collectively: every process asks
    for the same bytes) to hold ``nbytes`` a rank."""
    regions = mesh.group.regions
    st = regions.get("staging")
    if st is None or st.nbytes < nbytes:
        if st is not None:
            st.close()
        st = regions["staging"] = RankRegions(mesh, max(nbytes, 2 * (st.nbytes if st else 0)))
    return st


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _copy(dst: int, src: int, nbytes: int, dev) -> None:
    with torch.cuda.device(dev):
        _check(_lib().tp_copy(ctypes.c_void_p(dst), ctypes.c_void_p(src), nbytes,
                              ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)),
               "a copy between communication regions")


def _publish(mesh, nb: int, local: list[torch.Tensor], ranks) -> RankRegions:
    """Copy ``local[i]`` (global rank ``ranks[i]``'s, ``nb`` bytes each;
    every process passes the same ``nb``) into its staging region, wait for
    the copies, and pass the group's first barrier."""
    st = staging(mesh, nb)
    for r, x in zip(ranks, local):
        x = x.contiguous()
        _copy(st.base[r], x.data_ptr(), nb, x.device)
        torch.cuda.current_stream(x.device).synchronize()
    mesh.group.barrier()
    return st


def _read(mesh, st: RankRegions, like: torch.Tensor, ranks, local_of) -> list[torch.Tensor]:
    """Global ranks ``ranks``' tensors shaped as ``like`` on this process's
    first device: a local rank's straight from ``local_of(r)``, a peer's
    copied from its staging region."""
    dev = mesh.device
    nb = _nbytes(like)
    out = []
    for r in ranks:
        if r in mesh.ranks:
            out.append(local_of(r).to(dev, copy=True).contiguous())
            continue
        t = torch.empty(like.shape, dtype=like.dtype, device=dev)
        _copy(t.data_ptr(), st.base[r], nb, dev)
        out.append(t)
    torch.cuda.current_stream(dev).synchronize()
    return out


def gather_to_root(mesh, local: list[torch.Tensor]) -> list[torch.Tensor] | None:
    """Every rank's tensor (``local`` holds this process's ranks', all of
    one shape), in rank order, on process 0's first device; None on the
    other processes."""
    g = mesh.group
    if local[0].device.type == "cpu":
        got = g.gather(torch.stack(local))
        return None if got is None else [t for stack in got for t in stack]
    st = _publish(mesh, _nbytes(local[0]), local, mesh.ranks)
    out = None
    if g.index == 0:
        out = _read(mesh, st, local[0], range(mesh.tp), lambda r: local[r - mesh.rank0])
    g.barrier()
    return out


def all_gather(mesh, local: list[torch.Tensor]) -> list[torch.Tensor]:
    """Every rank's tensor, in rank order, on every process's first
    device."""
    g = mesh.group
    if local[0].device.type == "cpu":
        return [t for stack in g.all_gather(torch.stack(local)) for t in stack]
    st = _publish(mesh, _nbytes(local[0]), local, mesh.ranks)
    out = _read(mesh, st, local[0], range(mesh.tp), lambda r: local[r - mesh.rank0])
    g.barrier()
    return out


def broadcast_from_root(mesh, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """Global rank 0's ``tensors`` on every process, each on the device and
    in the shape and dtype of this process's own ``tensors`` (computed
    alike on every process, so the shapes agree)."""
    g = mesh.group
    flat = torch.cat([t.contiguous().view(torch.uint8).reshape(-1) for t in tensors])
    if flat.device.type == "cpu":
        flat = g.broadcast(flat)
    else:
        root = g.index == 0
        st = _publish(mesh, _nbytes(flat), [flat] if root else [], [0] if root else [])
        if g.index != 0:
            flat = _read(mesh, st, flat, [0], None)[0]
        g.barrier()
    out, off = [], 0
    for t in tensors:
        nb = _nbytes(t)
        out.append(flat[off:off + nb].clone().view(t.dtype).reshape(t.shape))
        off += nb
    return out
