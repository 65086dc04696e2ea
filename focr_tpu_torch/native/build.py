"""Build and bind the CUDA kernels of csrc/ (nvcc -> .so with a plain C
interface -> ctypes).

The library is built at first use into focr_tpu_torch/_build/, named by a hash
of the sources, the flags and the compiler, so a fresh checkout builds once
and a source edit rebuilds. Each source compiles in its own nvcc process, all
started together, and one more links the objects. Flags: sm_90a (Hopper), and
--fmad=false with no fast-math, because the ncc sweep's f32 threshold test
and the proportional decoder's f32 cursor rely on every op rounding on its
own (see csrc/ncc_sweep.cu and csrc/focr_prop.cu).

Run ``python -m focr_tpu_torch.native.build`` to build ahead of time and print
the compiler's register and shared-memory report.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("ncc_sweep.cu", "ncc_compact.cu", "focr_ssd.cu", "focr_prop.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-Xcompiler", "-fPIC",
)

_lib: ctypes.CDLL | None = None


def nvcc() -> str:
    """$CUDA_HOME/bin/nvcc, else nvcc on PATH, else /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: building the CUDA kernels needs the CUDA toolkit")


def library_path(compiler: str) -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    h.update("\0".join(NVCC_FLAGS + (compiler,)).encode())
    return os.path.join(BUILD_DIR, f"libfocr_kernels-{h.hexdigest()[:16]}.so")


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands concurrently; raise with the first failure's output,
    else return each one's compiler output."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}")
    return outs


def build(report: bool = False) -> str:
    """Compile csrc/ into the hashed .so unless it exists; return its path.
    ``report`` adds -Xptxas -v and prints the compiler's output."""
    compiler = nvcc()
    out = library_path(compiler)
    if os.path.exists(out) and not report:
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [os.path.join(tmpdir, s.replace(".cu", ".o")) for s in SOURCES]
        verbose = ["-Xptxas", "-v"] if report else []
        logs = _run_all([
            [compiler, *NVCC_FLAGS, *verbose, "-c", "-o", o, os.path.join(_CSRC, s)]
            for s, o in zip(SOURCES, objs)
        ])
        tmp = os.path.join(tmpdir, "lib.so")
        logs += _run_all([[compiler, "-shared", "-o", tmp, *objs]])
        if report:
            print("".join(logs), file=sys.stderr)
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def load() -> ctypes.CDLL:
    """The kernels' library, built if needed, with every entry point typed."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.focr_ncc_sweep.argtypes = [p, i, i, i, p, i, i, i, p, p, f, f, p, p, p, i, p, f, f, f]
    lib.focr_ncc_sweep.restype = i
    lib.focr_ncc_compact.argtypes = [p, p, p, p, ctypes.c_longlong, i, i, p]
    lib.focr_ncc_compact.restype = i
    lib.focr_ssd_argmin.argtypes = [p, ctypes.c_longlong, i, i, p, p, p, i, i, i, p, p, p]
    lib.focr_ssd_argmin.restype = i
    lib.focr_prop_scan.argtypes = [p, i, i, i, p, p, p, i, i, i, f, i, p, p]
    lib.focr_prop_scan.restype = i
    _lib = lib
    return lib


if __name__ == "__main__":
    print(build(report=True))
