"""Build the package's native code from the checkout's own sources.

Two shared libraries with plain C interfaces, loaded with ctypes:

* the CUDA kernels, ``kernels/csrc/*.cu``, compiled for ``sm_90a`` by
  one ``nvcc`` per source, all started together, then linked
  (:func:`cuda_library`);
* the contraction-path optimizer shared with the JAX package,
  ``native/path_optimizer.cpp``, compiled by ``g++`` the same way
  (:func:`compile_shared`, used by :mod:`tensor_networks_tpu_torch.native`).

Each library lands in ``kernels/_build/<hash of sources + flags>/``, so an
edited source or flag set never loads a stale binary, and the build runs
at first use: a fresh checkout builds everything on its first call.
``torch.utils.cpp_extension`` is not used: a source that includes
PyTorch's headers takes minutes to compile, a plain C interface seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence

BUILD_ROOT = Path(__file__).resolve().parent / "_build"
CSRC = Path(__file__).resolve().parent / "csrc"

NVCC_FLAGS = [
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
]
#: the storage types every H1 / H2 entry point is built for
DTYPE_SUFFIXES = ("f32", "f64", "bf16", "f16")

#: wall seconds of the last build of each library, by source and "link"
BUILD_SECONDS: Dict[str, Dict[str, float]] = {}

_LOCK = threading.Lock()
_CUDA_LIB: Optional[ctypes.CDLL] = None


def compile_shared(
    compiler: str,
    sources: Sequence[Path],
    flags: List[str],
    name: str,
    headers: Sequence[Path] = (),
) -> Path:
    """Compile ``sources`` into ``_build/<hash>/<name>`` unless present.

    Each source is compiled to an object by a process of its own, all
    started together, and the objects are then linked into one shared
    library.  The hash covers the compiler name, the flags and the bytes
    of every source and header.  The wall seconds of each compile and of
    the link land in :data:`BUILD_SECONDS` under the library's name.
    Raises ``RuntimeError`` carrying the compiler's stderr when the build
    fails.
    """
    digest = hashlib.sha256()
    digest.update(" ".join([compiler] + flags).encode())
    for src in list(sources) + list(headers):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    target = out_dir / name
    if target.exists():
        return target
    out_dir.mkdir(parents=True, exist_ok=True)
    # build under private names, then rename: a concurrent process never
    # loads a half-written library
    tmp = out_dir / f"tmp{os.getpid()}-{name}"
    objs = [out_dir / f"tmp{os.getpid()}-{s.stem}.o" for s in sources]
    secs = _run_all(
        [[compiler] + flags + ["-c", "-o", str(o), str(s)]
         for s, o in zip(sources, objs)],
        name,
    )
    secs += _run_all(
        [[compiler] + flags + ["-shared", "-o", str(tmp)] + [str(o) for o in objs]],
        name,
    )
    for o in objs:
        o.unlink()
    os.replace(tmp, target)
    BUILD_SECONDS[name] = dict(
        zip([s.name for s in sources] + ["link"], secs)
    )
    return target


def _run_all(cmds: List[List[str]], name: str) -> List[float]:
    """Start every command at once, wait for all, raise on the first
    that failed (with its stderr); returns each command's wall seconds."""

    def run(cmd):
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        return proc, time.perf_counter() - t0

    with ThreadPoolExecutor(len(cmds)) as pool:
        done = list(pool.map(run, cmds))
    for cmd, (proc, _) in zip(cmds, done):
        if proc.returncode != 0:
            raise RuntimeError(
                f"build of {name} failed ({' '.join(cmd)}):\n{proc.stderr}"
            )
    return [secs for _, secs in done]


def find_nvcc() -> str:
    """``nvcc`` from ``$CUDA_HOME``, then ``$PATH``, then the toolkit's
    standard install prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME or put the CUDA toolkit on PATH"
    )


_PTR = ctypes.c_void_p
_INT = ctypes.c_int


def _bind(lib: ctypes.CDLL) -> None:
    """Declare every entry point's C signature (pointers and the stream
    as ``void*``, sizes as ``int``); each returns a ``cudaError_t``."""
    for suffix in DTYPE_SUFFIXES:
        fn = getattr(lib, f"tnt_zipper_{suffix}")
        # fa ma la fb mb lb, w t part out, n0 n nl ra rb d_mid,
        # tile splits kchunk, stream
        fn.argtypes = [_PTR] * 10 + [_INT] * 9 + [_PTR]
        fn.restype = _INT
        fn = getattr(lib, f"tnt_zipper_fused_{suffix}")
        # fa ma la fb mb lb, w part out, n0 n nl ra rb d_mid nbands tmax,
        # stream
        fn.argtypes = [_PTR] * 9 + [_INT] * 8 + [_PTR]
        fn.restype = _INT
        fn = getattr(lib, f"tnt_evaluate_grouped_{suffix}")
        # first mids last idx perm tiles carry0 carry1 out,
        # B d n0 n nl r max_tiles tile_p, stream
        fn.argtypes = [_PTR] * 9 + [_INT] * 8 + [_PTR]
        fn.restype = _INT
    for suffix in ("f32", "f64"):  # the per-point yardstick
        fn = getattr(lib, f"tnt_evaluate_{suffix}")
        # first mids last idx out, B d n r, stream
        fn.argtypes = [_PTR] * 5 + [_INT] * 4 + [_PTR]
        fn.restype = _INT
    # vals tiles, B d_mid n max_tiles tile_p, stream
    lib.tnt_group_tiles.argtypes = [_PTR] * 2 + [_INT] * 5 + [_PTR]
    lib.tnt_group_tiles.restype = _INT
    lib.tnt_error_string.argtypes = [_INT]
    lib.tnt_error_string.restype = ctypes.c_char_p


def cuda_library() -> ctypes.CDLL:
    """The CUDA kernels' shared library, built on first use."""
    global _CUDA_LIB
    with _LOCK:
        if _CUDA_LIB is None:
            path = compile_shared(
                find_nvcc(),
                sorted(CSRC.glob("*.cu")),
                NVCC_FLAGS,
                "libtnt_kernels.so",
                headers=sorted(CSRC.glob("*.cuh")),
            )
            lib = ctypes.CDLL(str(path))
            _bind(lib)
            _CUDA_LIB = lib
        return _CUDA_LIB


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = lib.tnt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
