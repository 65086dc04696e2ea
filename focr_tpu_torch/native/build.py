"""Build and bind the two native libraries of csrc/, each a .so with a plain C
interface loaded with ctypes:

  the CUDA kernels (csrc/*.cu, nvcc) — the device stages of every path,
      the ncc exact f64 replay (K3) included;
  the ncc host library (csrc/ncc_host.cpp, g++) — post-processing (a page's
      in one call) and the all-host search (native/ncc_cpu.py), the PNG reader's row
      unfiltering (io/images.py), and the host copy of the exact replay that
      the tests hold K3 against.

Each is built at first use into focr_tpu_torch/_build/, named by a hash of its
sources and its flags (the host library's also by the compiler's name and the
host CPU), so a fresh checkout builds once, a source edit rebuilds, and a
library that is already built loads with no compiler present: neither name
runs a compiler. It is written under a temporary name and renamed, so a
concurrent loader sees all of it or nothing. A library that is missing and
cannot be built raises with the compiler's output (or the command that could
not start): nothing falls back to another implementation.

CUDA: each source compiles in its own nvcc process, all started together, and
one more links the objects. Flags: sm_90a (Hopper), and --fmad=false with no
fast-math, because the ncc sweep's f32 threshold test, the replay's f64
similarity and the proportional decoder's f32 cursor rely on every op
rounding on its own (see csrc/ncc_sweep.cu, csrc/ncc_replay.cu and
csrc/focr_prop.cu).

Host: g++ -O3 -march=native -ffp-contract=off -fopenmp. -ffp-contract=off is
load-bearing: gcc's default contraction fuses the replay's f64
multiply-subtracts into FMAs, and about 28% of similarities then differ from
the NumPy replay in the last bit. -march=native code built on one CPU can
fault with SIGILL on another that shares the tree, so the name's hash also
covers the host CPU's model and feature flags, read from /proc/cpuinfo.

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
SOURCES = ("ncc_sweep.cu", "ncc_compact.cu", "ncc_replay.cu", "focr_ssd.cu", "focr_prop.cu")
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


def library_path() -> str:
    """The CUDA library's path: a hash of the sources and NVCC_FLAGS."""
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    h.update("\0".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libfocr_kernels-{h.hexdigest()[:16]}.so")


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands concurrently; raise with the first failure's output
    (or with the command that could not start), else return each one's
    compiler output."""
    procs = []
    try:
        for c in cmds:
            procs.append(subprocess.Popen(c, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    except OSError as e:
        for p in procs:
            p.kill()
            p.wait()
        raise RuntimeError(f"`{' '.join(cmds[len(procs)])}` could not start: {e}") from e
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
    out = library_path()
    if os.path.exists(out) and not report:
        return out
    compiler = nvcc()
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
    lib.focr_ncc_sweep.argtypes = [p, i, i, i, p, i, i, i, p, p, f, f, p, p, p, i, f, f, f, i]
    lib.focr_ncc_sweep.restype = i
    lib.focr_ncc_compact_count.argtypes = [p, i, i, i, p, p, p, p, p, p, p]
    lib.focr_ncc_compact_count.restype = i
    lib.focr_ncc_compact.argtypes = [p, p, p, p, ctypes.c_longlong, i, i, p]
    lib.focr_ncc_compact.restype = i
    lib.focr_ncc_replay.argtypes = [p, i, i, i, p, ctypes.c_longlong, p, p, p, i, i,
                                    ctypes.c_double, i, i, ctypes.c_longlong, p, p]
    lib.focr_ncc_replay.restype = i
    lib.focr_ssd_argmin.argtypes = [p, ctypes.c_longlong, i, i, p, p, p, p, i, i, i, p, p, p]
    lib.focr_ssd_argmin.restype = i
    lib.focr_ssd_partial.argtypes = [p, ctypes.c_longlong, p, i, i, p, p, p]
    lib.focr_ssd_partial.restype = i
    lib.focr_ssd_combine.argtypes = [p, i, ctypes.c_longlong, p, p]
    lib.focr_ssd_combine.restype = i
    lib.focr_ssd_fold.argtypes = [p, i, ctypes.c_longlong, p, p]
    lib.focr_ssd_fold.restype = i
    lib.focr_prop_scan.argtypes = [p, i, i, i, p, i, p, p, i, i, i, f, i, p, p]
    lib.focr_prop_scan.restype = i
    _lib = lib
    return lib


def _host_cpu() -> bytes:
    """What -march=native resolves to, named without running the compiler:
    the first processor's model and feature lines of /proc/cpuinfo (x86
    "model name"/"flags", Arm "CPU implementer"/"CPU part"/"Features"), else
    the machine's architecture."""
    keys = {"vendor_id", "model name", "flags", "CPU implementer", "CPU part", "Features"}
    try:
        with open("/proc/cpuinfo", "rb") as f:
            block = f.read().split(b"\n\n", 1)[0]
    except OSError:
        return os.uname().machine.encode()
    lines = [ln for ln in block.splitlines() if ln.split(b":", 1)[0].strip().decode() in keys]
    return b"\n".join(lines) or os.uname().machine.encode()


def host_library_path() -> str:
    """The host library's path: a hash of the source, HOST_CXX's name,
    HOST_FLAGS and the host CPU (_host_cpu)."""
    h = hashlib.sha256()
    with open(os.path.join(_CSRC, HOST_SOURCE), "rb") as f:
        h.update(f.read())
    h.update("\0".join((HOST_CXX, *HOST_FLAGS)).encode())
    h.update(_host_cpu())
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
                i64,  # OpenMP team size (0: the runtime's default)
            ]
            lib.focr_ncc_replay_pos_u8.restype = None
            lib.focr_post_winners.argtypes = [p, p, i64, i64, p]  # key, sim, n, overlap, out
            lib.focr_post_winners.restype = i64
            lib.focr_post_page.argtypes = [
                p, p, p, p, i64,  # y, x, sim, needle ids, n
                ctypes.c_float, i64,  # anchor, overlap
                p, i64,  # the needles' letter codes, their number
                p, p, p, p,  # out winners, their codes, line bounds, their number
            ]
            lib.focr_post_page.restype = i64
            lib.focr_png_unfilter.argtypes = [p, i64, i64, i64, p]  # in, rows, stride, bpp, out
            lib.focr_png_unfilter.restype = i64
            _host_lib = lib
        return _host_lib


if __name__ == "__main__":
    print(build_host())
    print(build(report=True))
