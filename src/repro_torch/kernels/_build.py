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

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("decode_attention", "greedy_sample", "flash_attention",
           "rwkv6_scan", "mamba2_scan", "topk")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_longlong)
# C signatures of every exported function, by source
SIGNATURES = {
    "decode_attention": {
        "decode_attention_contiguous": [_P] * 6 + [_I] * 8
                                       + [_F, _I, _I, _P],
        "decode_attention_paged": [_P] * 9 + [_I] * 9 + [_F, _I, _I, _P],
    },
    "greedy_sample": {
        "greedy_sample_launch": [_P, _P, _P, _I, _I, _I, _I, _P],
    },
    "flash_attention": {
        "flash_attention_forward": [_P] * 5 + [_L] * 12 + [_I] * 8
                                   + [_F, _I, _P],
    },
    "rwkv6_scan": {
        "rwkv6_scan_forward": [_P] * 8 + [_L] * 16 + [_I] * 6 + [_P],
    },
    "mamba2_scan": {
        "mamba2_scan_forward": [_P] * 7 + [_L] * 16 + [_I] * 7 + [_P],
    },
    "topk": {
        "topk_launch": [_P, _P, _P, _I, _I, _I, _P],
    },
}

_libs: dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()
_count_lock = threading.Lock()
_recorder = threading.local()      # .counts: this thread's recording


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
    if name in _libs:
        return _libs[name]
    with _load_lock:              # executor threads may load it at once
        if name in _libs:
            return _libs[name]
        (path,) = build_all((name,))
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes, f.restype = argtypes, ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        _libs[name] = lib
    return _libs[name]


def count(wrapper, n: int = 1) -> None:
    """Add ``n`` to ``wrapper.launches``.  Under a lock: the mux executors
    launch the same kernel from two threads (flash attention in a
    rollout's prefill and in a train step), and ``+=`` on an attribute is
    a read-modify-write that can lose an increment.

    While this thread runs inside :func:`recording` (a CUDA graph capture:
    the wrapper's kernel is recorded, not launched) the count goes to the
    recording instead; the graph's owner adds it on every replay."""
    rec = getattr(_recorder, "counts", None)
    if rec is not None:
        rec[wrapper] = rec.get(wrapper, 0) + n
        return
    with _count_lock:
        wrapper.launches += n


@contextlib.contextmanager
def recording():
    """Collect this thread's :func:`count` calls into the yielded dict
    (wrapper -> launches) instead of the wrappers' counters.  Other
    threads keep counting into the wrappers, so a capture on one executor
    thread records exactly its own calls while the other thread
    launches."""
    if getattr(_recorder, "counts", None) is not None:
        raise RuntimeError("recording() does not nest")
    _recorder.counts = counts = {}
    try:
        yield counts
    finally:
        _recorder.counts = None


def add_counts(counts: dict) -> None:
    """Add a :func:`recording` to the wrappers' counters: what one replay
    of the graph it was recorded for launches."""
    for wrapper, n in counts.items():
        count(wrapper, n)


def check(name: str, err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if err:
        msg = getattr(load(name), f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
