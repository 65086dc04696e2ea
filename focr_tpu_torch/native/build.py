"""Build and bind the two native libraries of csrc/, each a .so with a plain C
interface loaded with ctypes:

  the CUDA kernels (csrc/*.cu, nvcc) — the device stages of every path;
  the ncc host library (csrc/ncc_host.cpp, g++) — the exact f64 replay, the
      post-processing scans and the all-host search (native/ncc_cpu.py).

Each is built at first use into focr_tpu_torch/_build/, named by a hash of its
sources, its flags and its compiler, so a fresh checkout builds once and a
source edit rebuilds; it is written under a temporary name and renamed, so a
concurrent loader sees all of it or nothing. A failed build raises with the
compiler's output: nothing falls back to another implementation.

CUDA: each source compiles in its own nvcc process, all started together, and
one more links the objects. Flags: sm_90a (Hopper), and --fmad=false with no
fast-math, because the ncc sweep's f32 threshold test and the proportional
decoder's f32 cursor rely on every op rounding on its own (see
csrc/ncc_sweep.cu and csrc/focr_prop.cu).

Host: g++ -O3 -march=native -ffp-contract=off -fopenmp. -ffp-contract=off is
load-bearing: gcc's default contraction fuses the replay's f64
multiply-subtracts into FMAs, and about 28% of similarities then differ from
the NumPy replay in the last bit. -march=native code built on one CPU can
fault with SIGILL on another that shares the tree, so the name's hash also
covers the compiler's view of the host CPU.

Run ``python -m focr_tpu_torch.native.build`` to build both ahead of time and
print the CUDA compiler's register and shared-memory report.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("ncc_sweep.cu", "ncc_compact.cu", "focr_ssd.cu", "focr_prop.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-Xcompiler", "-fPIC",
)

HOST_SOURCE = "ncc_host.cpp"
HOST_CXX = "g++"
HOST_FLAGS = (
    "-O3", "-march=native", "-ffp-contract=off", "-std=c++17",
    "-shared", "-fPIC", "-fopenmp",
)

_lib: ctypes.CDLL | None = None
_host_lib: ctypes.CDLL | None = None
_host_lock = threading.Lock()  # the collect pool's threads load it together


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
            raise RuntimeError(
                f"{os.path.basename(cmd[0])} failed ({p.returncode}): {' '.join(cmd)}\n{out}"
            )
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
    lib.focr_ncc_sweep.argtypes = [p, i, i, i, p, i, i, i, p, p, f, f, p, p, p, i, f, f, f]
    lib.focr_ncc_sweep.restype = i
    lib.focr_ncc_compact.argtypes = [p, p, p, p, ctypes.c_longlong, i, i, p]
    lib.focr_ncc_compact.restype = i
    lib.focr_ssd_argmin.argtypes = [p, ctypes.c_longlong, i, i, p, p, p, i, i, i, p, p, p]
    lib.focr_ssd_argmin.restype = i
    lib.focr_prop_scan.argtypes = [p, i, i, i, p, i, p, p, i, i, i, f, i, p, p]
    lib.focr_prop_scan.restype = i
    _lib = lib
    return lib


def _compiler_says(*args: str) -> str:
    """The host compiler's stdout for ``args``; raises if it cannot run."""
    cmd = [HOST_CXX, *args]
    try:
        return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError) as e:
        out = getattr(e, "stderr", "") or ""
        raise RuntimeError(
            f"building the ncc host library needs {HOST_CXX}: `{' '.join(cmd)}` "
            f"failed: {e}\n{out}"
        ) from e


def host_library_path() -> str:
    h = hashlib.sha256()
    with open(os.path.join(_CSRC, HOST_SOURCE), "rb") as f:
        h.update(f.read())
    h.update("\0".join((HOST_CXX, *HOST_FLAGS)).encode())
    h.update(_compiler_says("--version").encode())
    # what -march=native resolves to on this CPU: the target and every ISA flag
    h.update(_compiler_says("-march=native", "-Q", "--help=target").encode())
    return os.path.join(BUILD_DIR, f"libfocr_host-{h.hexdigest()[:16]}.so")


def build_host() -> str:
    """Compile csrc/ncc_host.cpp into the hashed .so unless it exists; return
    its path."""
    out = host_library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        tmp = os.path.join(tmpdir, "lib.so")
        _run_all([[HOST_CXX, *HOST_FLAGS, os.path.join(_CSRC, HOST_SOURCE), "-o", tmp]])
        os.replace(tmp, out)
    return out


def load_host() -> ctypes.CDLL:
    """The ncc host library, built if needed, with every entry point typed."""
    global _host_lib
    with _host_lock:
        if _host_lib is None:
            lib = ctypes.CDLL(build_host())
            p, i64 = ctypes.c_void_p, ctypes.c_int64
            lib.focr_ncc_search_u8.argtypes = [
                p, i64, i64, p, i64, i64, p, p, p, ctypes.c_float, p, i64,
            ]
            lib.focr_ncc_search_u8.restype = i64
            lib.focr_ncc_search_many_u8.argtypes = [
                p, i64, i64, p, i64, i64, i64, p, p, p, ctypes.c_float, p, i64, p,
            ]
            lib.focr_ncc_search_many_u8.restype = None
            lib.focr_ncc_replay_pos_u8.argtypes = [
                p, i64, i64,  # page, width, height
                p,  # positions
                p, p, i64,  # starts, ends, needles
                p, i64, i64,  # bank, n_w, n_h
                p, p,  # s_n, s2_n
                ctypes.c_double, i64, i64,  # threshold, row_len, max_matches
                p, p, p, p, p,  # out x, y, sim, counts, warn
            ]
            lib.focr_ncc_replay_pos_u8.restype = None
            for fn in (lib.focr_post_winners, lib.focr_post_sort_winners):
                fn.argtypes = [p, p, i64, i64, p]  # key, sim, n, overlap, out
                fn.restype = i64
            _host_lib = lib
        return _host_lib


if __name__ == "__main__":
    print(build_host())
    print(build(report=True))
