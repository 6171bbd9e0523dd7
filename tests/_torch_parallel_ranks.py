"""Rank side of tests/test_torch_parallel.py: what each rank of a gloo
world runs. The ranks are fresh processes that unpickle these functions
by module name, so this module imports torch and kofft_tpu_torch only,
never jax (nor the test module, nor conftest). Values that need every
rank (``full_tensor`` gathers) are computed on all of them; rank 0
returns them and the other ranks return None.
"""

import sys

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

import kofft_tpu_torch.parallel as P
from kofft_tpu_torch import config as C
from kofft_tpu_torch.parallel import validate as V

_MESHES: dict = {}


def mesh(spec="flat"):
    """The world's flat mesh, or a (slice, chip) mesh; made once per rank
    (a mesh of two dimensions creates process groups)."""
    if spec not in _MESHES:
        _MESHES[spec] = (P.make_mesh(device="cpu") if spec == "flat"
                         else P.make_hier_mesh(*spec, device="cpu"))
    return _MESHES[spec]


def _host(y):
    """A DTensor gathered (every rank calls), a tensor as numpy."""
    if isinstance(y, DTensor):
        y = y.full_tensor()
    return y.detach().numpy()


def _value(out):
    if isinstance(out, tuple):
        return _host(out[0]) + 1j * _host(out[1])
    return _host(out)


def _rank0(v):
    return v if dist.get_rank() == 0 else None


def _mesh_kw(name, spec):
    return {} if name.endswith("_auto") else {"mesh": mesh(spec)}


def call(name, *args, spec="flat", **kw):
    """``P.<name>(*args, mesh=..., **kw)`` gathered (complex for a plane
    pair)."""
    return _rank0(_value(getattr(P, name)(*args, **_mesh_kw(name, spec),
                                          **kw)))


def chain(steps, *args, spec="flat"):
    """Each step ``(name, kw[, extra])`` takes the previous step's output
    DTensors (then the ``extra`` arguments); the last one gathered."""
    out = args
    for name, kw, *extra in steps:
        out = getattr(P, name)(*out, *(extra[0] if extra else ()),
                               mesh=mesh(spec), **kw)
        out = out if isinstance(out, tuple) else (out,)
    return _rank0(_value(out if len(out) == 2 else out[0]))


def error(name, *args, spec="flat", **kw):
    """The name of the exception ``P.<name>`` raises (None if none)."""
    try:
        getattr(P, name)(*args, **_mesh_kw(name, spec), **kw)
    except Exception as e:
        return type(e).__name__
    return None


def auto(name, *args, threshold=None, overlap=None, **kw):
    """An auto entry under ``set_shard_threshold(threshold)`` and
    ``set_overlap_chunks(overlap)`` (reverted after): (sharded, value)."""
    C.set_shard_threshold(threshold)
    C.set_overlap_chunks(overlap)
    try:
        out = getattr(P, name)(*args, device="cpu", **kw)
    finally:
        C.set_shard_threshold(None)
        C.set_overlap_chunks(None)
    first = out[0] if isinstance(out, tuple) else out
    return _rank0((isinstance(first, DTensor), _value(out)))


def spy_fftn_auto(xr, xi, overlap):
    """fftn_auto with ``parallel.auto.fftn_sharded`` spied on: (keywords it
    was called with, value)."""
    from kofft_tpu_torch.parallel import auto as A
    seen = {}
    real = A.fftn_sharded

    def spy(a, b, **kw):
        seen.update(kw)
        return real(a, b, **kw)

    A.fftn_sharded = spy
    C.set_shard_threshold(1)
    C.set_overlap_chunks(overlap)
    try:
        out = A.fftn_auto(xr, xi, device="cpu")
    finally:
        A.fftn_sharded = real
        C.set_shard_threshold(None)
        C.set_overlap_chunks(None)
    seen.pop("mesh")
    return _rank0((seen, _value(out)))


def _summary(log):
    return {"a2a_bytes": sum(e.nbytes for e in log.a2a()),
            "total": len(log.a2a()),
            "independent_sources": log.independent_sources(),
            "by_group": V.a2a_bytes_by_group_size(log),
            "in_flight": [e.in_flight for e in log.entries],
            "log": log}


def logged(name, *args, spec="flat", **kw):
    """This rank's collective log of ``P.<name>`` (every rank returns
    its own)."""
    with V.comm_log() as log:
        getattr(P, name)(*args, mesh=mesh(spec), **kw)
    return _summary(log)


def comm_volume(n, restore_layout, overlap=1):
    return V.check_fft_sharded_comm_volume(n, mesh(), restore_layout=
                                           restore_layout, overlap=overlap)


def async_a2a_once():
    """One all_to_all issued async and waited on is logged once, at its
    issue, with its local bytes; a re/im pair counts two, both before
    the first wait."""
    from kofft_tpu_torch.parallel.mesh import _axis
    from kofft_tpu_torch.parallel.ndfft_sharded import _a2a, _wait
    axis = _axis(mesh(), "d")
    x = torch.zeros(16, 16)
    with V.comm_log() as one:
        _a2a(x, axis, 1, 0).wait()
    with V.comm_log() as pair:
        _wait(_a2a(x, axis, 1, 0), _a2a(x, axis, 1, 0))
    return _summary(one), _summary(pair)


def calibrate(**kw):
    """calibrate_shard_threshold(**kw): (threshold before, result,
    threshold after); the threshold is reverted after."""
    before = C.get_config().shard_threshold
    try:
        out = P.calibrate_shard_threshold(device="cpu", **kw)
        return before, out, C.get_config().shard_threshold
    finally:
        C.set_shard_threshold(None)


def calibrate_patched(kind, **kw):
    """calibrate with the JAX tests' fakes: ``"win"`` makes fft_sharded an
    instant winner, ``"unprobeable"`` makes no size factorize, ``"up"``
    runs a simulated clock on which sharding wins from 2^17 up."""
    import importlib
    import time as _time
    FS = importlib.import_module("kofft_tpu_torch.parallel.fft_sharded")
    import kofft_tpu_torch.ops.fft as OF
    saved = [(FS, "fft_sharded", FS.fft_sharded),
             (FS, "_split_for_mesh", FS._split_for_mesh),
             (OF, "fft_split", OF.fft_split),
             (_time, "perf_counter", _time.perf_counter)]
    clock = [0.0]
    if kind == "win":
        FS.fft_sharded = lambda a, b, **k: (a, b)
    elif kind == "unprobeable":
        FS._split_for_mesh = lambda n, d: None
    else:
        def fake_sharded(a, b, **k):
            clock[0] += 4.0 if a.shape[0] < (1 << 17) else 1.0
            return a, b

        def fake_local(a, b, **k):
            clock[0] += 2.0
            return a, b
        FS.fft_sharded, OF.fft_split = fake_sharded, fake_local
        _time.perf_counter = lambda: clock[0]
    try:
        return calibrate(**kw)
    finally:
        for mod, attr, value in saved:
            setattr(mod, attr, value)


def cuda_mesh_on_gloo():
    """A CUDA mesh on the gloo world, with torch.cuda.is_available()
    faked True: the name of what it raises (it must not fall back)."""
    real = torch.cuda.is_available
    torch.cuda.is_available = lambda: True
    try:
        P.make_mesh(device="cuda")
    except Exception as e:
        return type(e).__name__, str(e)
    finally:
        torch.cuda.is_available = real
    return None, ""


def jax_modules():
    """Modules of jax or kofft_tpu imported on this rank."""
    return [m for m in sys.modules if m == "jax" or m.startswith(
        ("jax.", "kofft_tpu.")) or m == "kofft_tpu"]
