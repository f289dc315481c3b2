"""ctypes binding of the C++ NUTS tree builder ``native/exmc_tree/tree.cpp``
(the contract of ``exmc_tpu/native/__init__.py``): it builds a tree from
precomputed leapfrog chains, and serves as the oracle that the batched
tree is held to.

The library is built with ``g++ -O2 -shared -fPIC`` at first use into
``build/exmc_tpu_torch/`` beside the package, under a name that carries
a hash of the source and the flags (as ``_build.py`` names the CUDA
libraries), so an edited source is rebuilt. If g++ or the build is
unavailable, ``available()`` returns False. Inputs are numpy arrays or
CPU tensors.
"""

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

SRC = Path(__file__).resolve().parents[2] / "native" / "exmc_tree" / "tree.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "exmc_tpu_torch"
CXX_FLAGS = ("-O2", "-shared", "-fPIC")

_lib = None
_load_error = None
# seconds of this process's g++ build (0.0 when the library was already built)
build_seconds = None


def library_path():
    """Where the library for the present source and flags lives."""
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libexmc_tree-{digest}.so"


def _build(target):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(SRC)], check=True,
                       capture_output=True)
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    global _lib, _load_error, build_seconds
    if _lib is not None or _load_error is not None:
        return _lib
    try:
        target = library_path()
        t0 = time.perf_counter()
        if not target.exists():
            _build(target)
            build_seconds = time.perf_counter() - t0
        else:
            build_seconds = 0.0
        lib = ctypes.CDLL(str(target))
        dp = ctypes.POINTER(ctypes.c_double)
        ip = ctypes.POINTER(ctypes.c_int)
        common = [
            dp, dp, ctypes.c_double,           # q0, p0, logp0
            dp, dp, dp, ctypes.c_int,          # forward chain
            dp, dp, dp, ctypes.c_int,          # backward chain
            ctypes.c_int, dp, ctypes.c_int,    # d, inv_mass, max_depth
            ctypes.c_double, ctypes.c_uint64,  # divergence threshold, seed
        ]
        outs = [ip, ip, ip, ip, dp]
        lib.exmc_build_full_tree.argtypes = common + outs
        lib.exmc_build_full_tree.restype = ctypes.c_int
        lib.exmc_build_full_tree_dirs.argtypes = common + [ip] + outs  # + forced dirs
        lib.exmc_build_full_tree_dirs.restype = ctypes.c_int
        _lib = lib
    except Exception as e:  # noqa: BLE001 - toolchain-dependent; see available()
        _load_error = e
    return _lib


def available() -> bool:
    return _load() is not None


def _f64(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().numpy()  # raises for a tensor on a card
    return np.ascontiguousarray(x, np.float64)


def _cptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def build_full_tree(q0, p0, logp0, fwd, bwd, inv_mass, max_depth=10,
                    divergence_threshold=1000.0, seed=0, dirs=None):
    """Build a NUTS tree from precomputed leapfrog chains.

    ``fwd``/``bwd``: tuples (q[n, d], p[n, d], logp[n]) of the forward
    and backward chains from the initial point. The backward chain is
    the leapfrog integration with step -eps, its momenta kept oriented in
    forward time (the signed-eps convention of the batched tree), since
    rho sums and U-turn dot products mix momenta of both chains.

    ``dirs``: optional per-doubling directions (+1/-1, at least
    ``max_depth`` of them) in place of the internal generator's coin
    flips. The tree's shape is a function of the geometry and the
    directions, which is what a lockstep test holds fixed.

    Returns dict(ok, selected, depth, n_leapfrog, diverging,
    accept_prob); ``selected`` is a signed step index."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native tree unavailable: {_load_error}")
    q0, p0 = _f64(q0), _f64(p0)
    qf, pf, lf = (_f64(x) for x in fwd)
    qb, pb, lb = (_f64(x) for x in bwd)
    d = q0.shape[0]
    inv_mass = _f64(inv_mass)

    sel, depth, n_lf, div = (ctypes.c_int() for _ in range(4))
    acc = ctypes.c_double()
    common = (
        _cptr(q0), _cptr(p0), ctypes.c_double(float(logp0)),
        _cptr(qf), _cptr(pf), _cptr(lf), ctypes.c_int(qf.shape[0]),
        _cptr(qb), _cptr(pb), _cptr(lb), ctypes.c_int(qb.shape[0]),
        ctypes.c_int(d), _cptr(inv_mass), ctypes.c_int(max_depth),
        ctypes.c_double(divergence_threshold), ctypes.c_uint64(seed),
    )
    outs = (ctypes.byref(sel), ctypes.byref(depth), ctypes.byref(n_lf),
            ctypes.byref(div), ctypes.byref(acc))
    if dirs is None:
        rc = lib.exmc_build_full_tree(*common, *outs)
    else:
        dirs = np.ascontiguousarray(
            dirs.numpy() if isinstance(dirs, torch.Tensor) else dirs, np.int32)
        # an explicit check (not an assert): the C side reads dirs[depth]
        # unchecked, so a short or non-+-1 array is undefined behaviour
        if dirs.shape[0] < max_depth or not np.all(np.abs(dirs) == 1):
            raise ValueError(
                f"dirs must have >= max_depth ({max_depth}) entries of "
                f"+1/-1; got shape {dirs.shape}")
        rc = lib.exmc_build_full_tree_dirs(
            *common, dirs.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), *outs)
    return {
        "ok": rc == 0,
        "selected": sel.value,
        "depth": depth.value,
        "n_leapfrog": n_lf.value,
        "diverging": bool(div.value),
        "accept_prob": acc.value,
    }
