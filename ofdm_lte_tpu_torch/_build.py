"""Build the package's CUDA kernels with nvcc and load them with ctypes.

The first call compiles every `csrc/*.cu` (which may include the `*.cuh`
beside it) to an object file, one nvcc for each source and all started
together,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c -o build/<name>.<hash>.o csrc/<name>.cu

links them into one shared library with a plain C interface,
`build/libofdm_lte_tpu_torch_<hash>.so`, under the repository's git-ignored
`build/` directory, with nvcc's output beside it (`.log`, registers and
spills of every kernel), and loads it. The file name carries a hash of the
sources and flags, so a library is rebuilt only when they change. Nothing
is built at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the complex GEMMs, one for each form and precision, each exported as
# cmatmul_<name> and cmatmul_<name>_splits with one C signature: highest
# (3xTF32; 4-dot: wgmma and TMA, csrc/cmatmul_wgmma_tf32x3.cu; Gauss:
# mma.sync, csrc/cmatmul_tc_gauss.cu), high (TF32, wgmma and TMA:
# csrc/cmatmul_wgmma_tf32.cu) and default (bf16, wgmma and TMA:
# csrc/cmatmul_bf16.cu), each in the 4-dot and the Gauss form
TC_KERNELS = ("tf32x3", "tf32x3_gauss", "tf32", "tf32_gauss", "bf16", "bf16_gauss")
# those whose `scratch` argument is a workspace of the size that
# cmatmul_<name>_workspace(ar, ai, lda, M, N, K, splits) returns, in floats:
# the wgmma kernels (tf32x3_gauss takes 2·splits·M·N floats of partial planes
# when splits > 1)
WORKSPACE_KERNELS = ("tf32x3", "tf32", "tf32_gauss", "bf16", "bf16_gauss")

_lib = None
build_log = ""          # compiler output of the library's build (kept beside it)
build_seconds = 0.0     # 0.0 when the library was already built


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the package's CUDA kernels are built from csrc/ with it")


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):     # headers enter the hash too
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libofdm_lte_tpu_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu unless a library for these sources exists."""
    global build_log, build_seconds
    out = library_path()
    if out.exists():
        log = out.with_suffix(".log")
        build_log = build_log or (log.read_text() if log.exists() else "")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in _sources()]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        procs = [(subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                   text=True), src)
                 for obj, src in zip(objs, _sources())]
        logs = [(src, proc.communicate()[0], proc.returncode) for proc, src in procs]
        build_log = "".join(log for _, log, _ in logs)
        failed = [src.name for src, _, rc in logs if rc != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed} with flags "
                               f"{' '.join(NVCC_FLAGS)}\n{build_log}")
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        build_log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed to link {out.name}\n{build_log}")
        out.with_suffix(".log").write_text(build_log)
        os.replace(tmp, out)
    finally:
        build_seconds = time.perf_counter() - t0
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        for name in TC_KERNELS:
            fn = getattr(lib, "cmatmul_" + name)
            fn.argtypes = [p, p, i, p, p, i, p, p, i, i, i, i, p, i, p]
            fn.restype = i
            fn = getattr(lib, f"cmatmul_{name}_splits")
            fn.argtypes = [i, i, i, i]
            fn.restype = i
        for name in WORKSPACE_KERNELS:
            fn = getattr(lib, f"cmatmul_{name}_workspace")
            fn.argtypes = [p, p, i, i, i, i, i]
            fn.restype = ctypes.c_longlong
        for name in ("tf32", "bf16"):          # the wgmma kernels' shared memory a block
            fn = getattr(lib, f"cmatmul_{name}_smem_bytes")
            fn.argtypes = [i]                  # gauss
            fn.restype = i
        lib.cmatmul_tf32x3_smem_bytes.argtypes = []
        lib.cmatmul_tf32x3_smem_bytes.restype = i
        lib.turbo_bcjr.argtypes = [p, p, p, p, i, p, p, i, i, i, i, p]
        lib.turbo_bcjr.restype = i
        ip, fp = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float)
        lib.multipath_fir.argtypes = [p] * 8 + [i] * 8 + [ip, ip, ip, fp, p]
        lib.multipath_fir.restype = i
        pp, f = ctypes.POINTER(ctypes.c_void_p), ctypes.c_float
        lib.sic_detect.argtypes = [p, p, pp, pp, p, p, p, f, i, p, p, i, i, i, i, i, f, f, p]
        lib.sic_detect.restype = i
        _lib = lib
    return _lib
