"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` for ``sm_90a`` (all
started together), the objects are linked into one shared library with a
plain C interface, and the library is loaded with ``ctypes``. The build
lands in ``build/repro_torch/`` at the root of the checkout, named by a
hash of the sources and flags, so a second call in the same checkout
reuses it. Nothing is built at import time: the first wrapper launch on a
CUDA tensor builds.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
#: C entry points: every one returns its cudaError_t as an int.
SIGNATURES = {
    "gs_flash_attention": [_I, _P, _P, _P, _P,  # dtype, q, k, v, o
                           _I, _I, _I, _I, _I, _I,  # B, Sq, Sk, H, Hkv, D
                           _L, _L, _L, _L, _L, _L,  # q, k strides (b, s, h)
                           _L, _L, _L, _L, _L, _L,  # v, o strides (b, s, h)
                           _I, _I, _F, _P],  # causal, window, scale, stream
    "gs_rmsnorm": [_I, _P, _P, _P, _L, _I, _I, _F, _P],  # dtype, x, scale,
    #                                         y, rows, d, groups, eps, stream
    "gs_ssd_scan": [_I, _P, _P, _P, _P, _P, _P,  # dtype, x, dt, A, B, C, D
                    _P, _P, _P,  # initial state (or null), y, final state
                    _P, _P, _P,  # workspaces: chunk sums, C.B^T, chunk states
                    _I, _I, _I, _I, _I, _I, _I,  # B, S, H, G, P, N, chunk
                    _L, _L, _L, _L, _L, _L,  # x, dt strides (b, s, h)
                    _L, _L, _L, _L, _L, _L,  # B, C strides (b, s, g)
                    _P],  # stream
    "gs_grouped_matmul": [_I, _P, _P, _P,  # dtype, x, w, out
                          _I, _I, _I, _I, _P],  # E, C, d, f, stream
}


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float  # wall time of this call (0-ish when cached)
    cached: bool
    log: str  # nvcc/ptxas output ("" when cached)


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def find_nvcc() -> str:
    candidates = [os.path.join(os.environ[v], "bin", "nvcc")
                  for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    candidates += ["/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked at $CUDA_HOME, /usr/local/cuda "
                       "and PATH): the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(nvcc: str) -> str:
    h = hashlib.sha256(" ".join((nvcc,) + NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> BuildInfo:
    """Compile and link the kernels unless a library of the same sources
    and flags already exists. Raises with nvcc's output on failure."""
    t0 = time.perf_counter()
    nvcc = find_nvcc()
    out_dir = build_dir()
    so = out_dir / f"libgreenscale_kernels_{_digest(nvcc)}.so"
    if so.exists():
        return BuildInfo(so, time.perf_counter() - t0, True, "")
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, objs, failed = [], [], []
        for src, obj, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== {src.name}\n{text}")
            objs.append(str(obj))
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_so = Path(tmp) / so.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-Xcompiler", "-fPIC",
             "-o", str(tmp_so), *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link\n{link.stdout}")
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(log))
        os.replace(tmp_so, so)
    return BuildInfo(so, time.perf_counter() - t0, False, "\n".join(log))


_LIB: ctypes.CDLL | None = None


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build().path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB
