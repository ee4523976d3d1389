"""Native (C++) host components, built on demand with g++.

The shared library is compiled into this directory under a name keyed by
a hash of the sources, the compiler flags and the host (machine type and
CPU feature flags): ``-march=native`` code built on one CPU can die with
SIGILL on another, so a library built elsewhere is never loaded, only
rebuilt. Set METABULI_TPU_NO_NATIVE=1 to force the pure-Python fallbacks.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

_LOCK = threading.Lock()
_LIB = None
_LIB_PATH: str | None = None
_TRIED = False

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRCS = [
    os.path.join(_DIR, name)
    for name in ("taxonomer.cpp", "masker.cpp", "genepred.cpp",
                 "prodigal.cpp", "fastx.cpp", "sortkeys.cpp")
]


def host_key() -> str:
    """Machine type plus the CPU feature flags -march=native builds for."""
    flags = ""
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith(("flags", "Features")):
                    flags = " ".join(sorted(line.split(":", 1)[1].split()))
                    break
    except OSError:
        flags = platform.processor()
    return f"{platform.machine()}:{flags}"


def _compile_flags(sanitize: str) -> list[str]:
    # -ffp-contract=off: the Prodigal port's double arithmetic must not be
    # FMA-contracted — bit-exactness vs the (-O2, no -march) compiled
    # reference oracle depends on plain IEEE mul+add sequences
    flags = ["-O3", "-march=native", "-ffp-contract=off", "-fopenmp",
             "-shared", "-fPIC", "-std=c++17"]
    if sanitize:
        flags[:0] = [f"-fsanitize={sanitize}", "-fno-omit-frame-pointer",
                     "-g"]
    return flags


def library_path(sanitize: str = "") -> str:
    """Path of the library for these sources, flags and this host."""
    h = hashlib.sha256()
    for src in _SRCS:
        with open(src, "rb") as fh:
            h.update(fh.read())
    h.update("\0".join(_compile_flags(sanitize)).encode())
    h.update(host_key().encode())
    tag = ".asan" if sanitize else ""
    return os.path.join(_DIR,
                        f"libmetabuli_native-{h.hexdigest()[:16]}{tag}.so")


def _build() -> str | None:
    # METABULI_TPU_SANITIZE=address[,undefined] builds an ASan/UBSan
    # variant (separate .so; the test suite's sanitizer pass uses it —
    # run python under LD_PRELOAD=$(g++ -print-file-name=libasan.so))
    sanitize = os.environ.get("METABULI_TPU_SANITIZE", "")
    so = library_path(sanitize)
    if os.path.exists(so):
        return so
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", *_compile_flags(sanitize), *_SRCS, "-o", tmp, "-lz"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp, so)
        return so
    except (subprocess.CalledProcessError, OSError, subprocess.TimeoutExpired) as e:
        stderr = getattr(e, "stderr", b"")
        print(f"[metabuli_tpu] native build failed, using Python fallback: "
              f"{stderr[:500] if stderr else e}")
        return None


def loaded_path() -> str | None:
    """Path of the loaded native library, or None (Python fallbacks)."""
    get_lib()
    return _LIB_PATH


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _LIB, _LIB_PATH, _TRIED
    if os.environ.get("METABULI_TPU_NO_NATIVE"):
        return None
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        so = _build()
        if so is None:
            return None
        lib = ctypes.CDLL(so)
        lib.taxonomer_assign.restype = ctypes.c_int64
        lib.taxonomer_finish.restype = ctypes.c_int64
        _LIB, _LIB_PATH = lib, so
        return _LIB
