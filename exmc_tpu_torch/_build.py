"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled for
Hopper (``sm_90a``) into a shared library under ``build/exmc_tpu_torch/``
beside the package, at first use. The library's file name carries a hash
of the source and the flags, so an edited source is rebuilt. Nothing is
built when the package is imported.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "exmc_tpu_torch"

# --fmad=false: no multiply-add contraction, so a kernel rounds each step
# as the plain PyTorch version of the same arithmetic does
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED = {}


def sources():
    """Names of the CUDA sources in ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin)")


def _target(name):
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=None):
    """Compile the named sources (all by default), one nvcc process per
    source, all started together. Returns {name: {"path", "seconds",
    "log"}} where ``log`` is nvcc's output (``-Xptxas -v``: registers,
    spills); a source already built is not compiled again and reports
    ``seconds`` 0. Raises if a build fails."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, running = {}, {}
    for name in names:
        target = _target(name)
        if target.exists():
            out[name] = {"path": str(target), "seconds": 0.0, "log": ""}
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, target, time.perf_counter())
    for name, (proc, tmp, target, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, target)
        out[name] = {"path": str(target), "seconds": seconds, "log": log}
    return out


def load(name):
    """The ctypes library of ``csrc/<name>.cu``, built at first use."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(build_all([name])[name]["path"])
        _LOADED[name] = lib
    return lib
