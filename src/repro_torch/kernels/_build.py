"""Build the CUDA sources in ``kernels/csrc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled on
first use by ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC`` into ``build/repro_torch_kernels/`` at the repository
root, under a file name keyed by a hash of the source and the flags, so an
edited source rebuilds and an unchanged one is reused.  Nothing includes
PyTorch's headers: the wrappers pass raw pointers and the current stream,
which keeps a build to seconds.  :func:`build_all` starts one ``nvcc`` per
source at once.

Nothing here runs at import time: the CPU tests import every module, and
this machine needs neither ``nvcc`` nor a card until a kernel launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("decode_attention", "greedy_sample", "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_longlong)
# C signatures of every exported function, by source
SIGNATURES = {
    "decode_attention": {
        "decode_attention_contiguous": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                        _I, _I, _F, _I, _I, _P],
        "decode_attention_paged": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                   _I, _I, _I, _I, _I, _F, _I, _I, _P],
    },
    "greedy_sample": {
        "greedy_sample_launch": [_P, _P, _P, _I, _I, _P],
    },
    "flash_attention": {
        "flash_attention_forward": [_P] * 5 + [_L] * 12 + [_I] * 7
                                   + [_F, _I, _P],
    },
}

_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, else ``/usr/local/cuda/bin``,
    else ``PATH``.  Raises when there is none."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are built from source at first use")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> list[Path]:
    """Compile every source whose library is missing, all ``nvcc``
    processes started together; returns the library paths.  A failed
    build raises with the compiler's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: _lib_path(n) for n in names}
    procs = []
    for n, path in todo.items():
        if path.exists():
            continue
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs.append((n, path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for n, path, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            errors.append(f"nvcc failed on {n}.cu:\n{out}")
        else:
            os.replace(tmp, path)
    if errors:
        raise RuntimeError("\n".join(errors))
    return list(todo.values())


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` with its argument types set
    (building it first if needed)."""
    if name not in _libs:
        (path,) = build_all((name,))
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes, f.restype = argtypes, ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        _libs[name] = lib
    return _libs[name]


def check(name: str, err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if err:
        msg = getattr(load(name), f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
