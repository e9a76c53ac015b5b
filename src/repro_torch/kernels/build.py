"""Build and bind the port's CUDA kernels.

Each source in ``kernels/csrc`` compiles with ``nvcc`` into a shared library
with a plain C interface, loaded with :mod:`ctypes` (seconds per build; no
PyTorch headers).  Libraries go to ``build/kernels/`` at the repository
root, named by a hash of their source, at first use.  :func:`build_all`
starts one ``nvcc`` per source at once and waits for all of them.

Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["SOURCES", "build_dir", "build_all", "load", "check", "ptxas_log"]

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {
    "quantease_cd": _CSRC / "quantease_cd.cu",
    "dequant_matmul": _CSRC / "dequant_matmul.cu",
    "paged_attention": _CSRC / "paged_attention.cu",
}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C signature of every exported function: (argtypes, restype).
_SIGNATURES = {
    "quantease_cd": {
        "qe_block_sweep": ([_P] * 7 + [_I, _I, _I, _L, _L] + [_I] * 5 + [_P, _I], _I),
        "qe_sweep_ctas_per_sm": ([_I] * 4, _I),
        "qe_block_corr": ([_P, _I] + [_P] * 5 + [_I] * 7 + [_P, _I], _I),
        "qe_outlier_corr": ([_P, _I] + [_P] * 6 + [_I] * 7 + [_P, _I], _I),
        "qe_suffix_resid": ([_P, _I] + [_P] * 3 + [_I] * 5 + [_P, _I], _I),
        "qe_corr_ctas_per_sm": ([_I] * 4, _I),
    },
    "dequant_matmul": {
        "dequant_matmul": ([_P, _I, _P, _I, _P, _P, _P, _I] + [_I] * 7 + [_P, _P, _I], _I),
    },
    "paged_attention": {
        "paged_attention": ([_P, _I, _P, _P, _I] + [_P] * 6 + [_I] * 7 + [_F, _F, _I, _P, _I], _I),
        "paged_ctas_per_sm": ([_I] * 5, _I),
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    """``build/kernels`` under the repository root (created on demand)."""
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes() + " ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_all(names=None) -> dict:
    """Compile every missing library, all ``nvcc`` processes at once.

    Returns ``{name: seconds}`` (0.0 where the library was already built).
    Raises with the compiler's output if any build fails; the ``-Xptxas -v``
    report (registers, shared memory, spills) is kept beside each library
    as ``<lib>.log``.
    """
    names = list(SOURCES) if names is None else list(names)
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = _lib_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, target, time.monotonic())
    seconds = {name: 0.0 for name in names}
    failures = []
    for name, (proc, tmp, target, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.monotonic() - t0
        target.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The bound library ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, (argtypes, restype) in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _LIBS[name] = lib
    return lib


def ptxas_log(name: str) -> str:
    """The compiler's ``-Xptxas -v`` report for library ``name`` (registers,
    shared memory and spills per kernel), as :func:`build_all` kept it;
    empty if the library was not built here."""
    path = _lib_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
