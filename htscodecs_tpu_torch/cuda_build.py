"""Build and load the port's CUDA kernels.

The sources in ``csrc/*.cu`` have a plain C interface (one
``*_launch`` function per kernel that returns ``cudaGetLastError()``).
At first use they are compiled by ``nvcc`` for ``sm_90a`` — one
compiler process per source, all started together — and linked into
one shared library under the package's ``_build/`` directory, keyed by
the sources' content hash, then loaded with ``ctypes``.  Nothing is
built when the package is imported, and there is no fallback: without
``nvcc`` or with a source that does not compile, ``get_lib()`` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
_lock = threading.Lock()
build_seconds = 0.0     # wall time of the last build in this process
build_log = ""          # the compilers' output (register / spill report)

_vp = ctypes.c_void_p
_int = ctypes.c_int


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe:
        return exe
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    exe = os.path.join(home, "bin", "nvcc")
    if os.path.exists(exe):
        return exe
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _build() -> Path:
    global build_seconds, build_log
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    tag = h.hexdigest()[:16]
    so = BUILD_DIR / f"libhtscuda_{tag}.so"
    if so.exists():
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    pid = os.getpid()
    objs = [BUILD_DIR / f".{s.stem}_{tag}.{pid}.o" for s in srcs]
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for s, o in zip(srcs, objs)]
    logs = []
    failed = False
    for s, p in zip(srcs, procs):
        out, _ = p.communicate()
        logs.append(f"== {s.name}\n{out}")
        failed |= p.returncode != 0
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError("nvcc failed:\n" + build_log)
    tmp = BUILD_DIR / f".cuda_{tag}.{pid}.so"
    r = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for o in objs:
        o.unlink(missing_ok=True)
    if r.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + r.stdout)
    tmp.replace(so)
    build_seconds = time.perf_counter() - t0
    return so


def _declare(lib) -> None:
    lib.rans16_dec_launch.restype = _int
    lib.rans16_dec_launch.argtypes = [_vp] * 7 + [_int] * 7 + [_vp]
    lib.rans16_dec_direct_launch.restype = _int
    lib.rans16_dec_direct_launch.argtypes = [_vp] * 7 + [_int] * 6 + [_vp]
    lib.rans16_dec_direct_ctas_per_sm.restype = _int
    lib.rans16_dec_direct_ctas_per_sm.argtypes = [_int] * 3
    lib.rans16_dec_packed_launch.restype = _int
    lib.rans16_dec_packed_launch.argtypes = [_vp] * 7 + [_int] * 7 + [_vp]
    lib.rans16_enc_packed_launch.restype = _int
    lib.rans16_enc_packed_launch.argtypes = [_vp] * 7 + [_int] * 6 + [_vp]
    lib.rans8_enc_launch.restype = _int
    lib.rans8_enc_launch.argtypes = [_vp] * 6 + [_int] * 6 + [_vp]
    lib.rans8_dec_launch.restype = _int
    lib.rans8_dec_launch.argtypes = [_vp] * 6 + [_int] * 7 + [_vp]
    lib.rans8_dec_direct_launch.restype = _int
    lib.rans8_dec_direct_launch.argtypes = [_vp] * 6 + [_int] * 5 + [_vp]
    lib.rans8_dec_direct_ctas_per_sm.restype = _int
    lib.rans8_dec_direct_ctas_per_sm.argtypes = [_int] * 2
    lib.arith_enc_launch.restype = _int
    lib.arith_enc_launch.argtypes = [_vp] * 6 + [_int] * 9 + [_vp]
    lib.arith_dec_launch.restype = _int
    lib.arith_dec_launch.argtypes = [_vp] * 7 + [_int] * 7 + [_vp]
    lib.rc_enc_launch.restype = _int
    lib.rc_enc_launch.argtypes = [_vp] * 6 + [_int] * 5 + [_vp]
    lib.tables_o1_presence_launch.restype = _int
    lib.tables_o1_presence_launch.argtypes = [_vp] * 2 + [_int] * 2 + [_vp]
    lib.tables_o1_count_launch.restype = _int
    lib.tables_o1_count_launch.argtypes = [_vp] * 3 + [_int] * 3 + [_vp]


def get_lib():
    """The loaded kernel library; builds it on first call."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(str(_build()))
                _declare(lib)
                _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a ``*_launch`` entry reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
