"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every source ``kernels/csrc/<name>.cu`` becomes its own shared library with
a plain C interface, compiled for ``sm_90a`` (Hopper) on first use into
``kernels/_build/`` (listed in ``.gitignore``).  A library's file name
carries a hash of its source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source is rebuilt and a stale library is never
loaded.  :func:`build` starts one ``nvcc`` per out-of-date source, all at
once, and waits for them together; each library's build wall time goes to
:func:`repro_torch.analysis.instrument.record_build`.

Nothing here runs at import: the CPU tests import every module, and this
container has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from repro_torch.analysis.instrument import record_build

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: dict = {}  # name -> loaded ctypes.CDLL (one per process)


def sources() -> list:
    """Names of every kernel source in ``csrc/`` (without ``.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else
    ``/usr/local/cuda/bin/nvcc``, else ``nvcc`` on the PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "are built on the machine that has the card")
    return found


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=None) -> dict:
    """Compile every out-of-date source of ``names`` (default: all) in
    parallel.  Returns ``{name: compiler log}`` for the sources it compiled
    (``-Xptxas=-v``: registers, shared memory and spills per kernel).
    Raises with the compiler's output if any compile fails."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out, time.perf_counter())
    logs, failed = {}, []
    for name, (proc, tmp, out, t0) in jobs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a reader never sees half a file
            record_build(name, time.perf_counter() - t0)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    return lib


def raw_stream(index: int) -> int:
    """The handle of device ``index``'s current CUDA stream (a graph's
    capture stream while one is captured), without the ``torch.cuda.Stream``
    object ``current_stream`` builds: the wrappers' enqueue takes it once a
    launch."""
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return raw(index) if raw is not None else torch.cuda.current_stream(index).cuda_stream


def require_cuda(t, what: str) -> None:
    """Raise unless ``t`` lies on a CUDA device (a wrapper launches its
    kernel or raises; the plain versions are in ``kernels.ref``)."""
    if t.device.type != "cuda":
        raise ValueError(f"{what} launches a CUDA kernel; got a tensor on "
                         f"{t.device} (the plain version is in kernels.ref)")


def check_launch(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")
