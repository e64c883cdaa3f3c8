"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use with nvcc for sm_90a into ``_build/`` (listed in .gitignore), then
loaded with ctypes.  The library name carries a hash of the sources, so an
edited kernel is rebuilt and a stale build is never loaded.  No fast-math:
IEEE division and sqrt everywhere, and -fmad=false so every kernel rounds
operation by operation like its plain PyTorch version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

_HERE = pathlib.Path(__file__).resolve().parent
_SRC = _HERE / "csrc"
_BUILD = _HERE / "_build"
_LIBS = {}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false"]


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (pathlib.Path(cand) / "bin" / "nvcc").exists():
            return str(pathlib.Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit on the machine with the card")
    return found


def _lib_path(name: str) -> pathlib.Path:
    src = _SRC / f"{name}.cu"
    h = hashlib.sha1()
    for p in [src, *sorted(_SRC.glob("*.cuh"))]:
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD / f"lib{name}-{h.hexdigest()[:12]}.so"


def sources():
    """The kernel sources of csrc/ by name (csrc/<name>.cu)."""
    return sorted(p.stem for p in _SRC.glob("*.cu"))


def build(names) -> None:
    """Compile csrc/<name>.cu for every name not built yet, one nvcc per
    source, all started together."""
    _BUILD.mkdir(exist_ok=True)
    jobs = []
    for name in dict.fromkeys(names):
        lib = _lib_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(_SRC), "-o", str(tmp),
               str(_SRC / f"{name}.cu")]
        jobs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors = []
    for name, lib, tmp, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{err}")
        else:
            os.replace(tmp, lib)
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu (built on first use)."""
    if name not in _LIBS:
        build([name])
        _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    return _LIBS[name]


_CT = {"p": ctypes.c_void_p, "i": ctypes.c_longlong, "f": ctypes.c_float}


def launch(name: str, symbol: str, sig: str, *args) -> None:
    """Call a C entry with the current stream appended; raise on a CUDA
    error code (the entry returns cudaGetLastError())."""
    f = getattr(load(name), symbol)
    if f.argtypes is None:
        f.argtypes = [_CT[c] for c in sig] + [ctypes.c_void_p]
        f.restype = ctypes.c_int
    conv = []
    for c, a in zip(sig, args):
        if c == "p":
            conv.append(ctypes.c_void_p(a.data_ptr()))
        elif c == "i":
            conv.append(ctypes.c_longlong(int(a)))
        else:
            conv.append(ctypes.c_float(float(a)))
    stream = torch.cuda.current_stream().cuda_stream
    err = f(*conv, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"CUDA kernel {symbol} failed with error {err}")
