"""What sets K1's pace on a CUDA card: its wgmma instance rebuilt with one
part of its work changed, each timed on the ncc fixture's first wave (both
needle groups, the kept launch shape) beside the unchanged kernel.

    python tools/torch_k1_probes.py [PROBE ...]     # default: every probe

Probes (source edits of csrc/ncc_sweep.cu; only "base" keeps the output
right, the others exist to be timed):

  base          — unchanged, held bit for bit against the plain version
  tensor-x2     — every wgmma chain issued twice: twice the tensor work
  epilogue-half — a full group of 64 needles tests 32 of them
  no-stores     — the store pass writes no mask word (counts stay)
  store-signed  — the store pass's indices divided as signed ints
  stamps        — clock64 stamps of thread 0 of every block, summed by
                  phase (cycles a tile): where a warpgroup waits

Each probe is a copy of the package under focr_tpu_torch/_build/probes/
(ignored by git) built with its own nvcc runs (``build_all``: a few copies
at once), then timed in a process of its own (torch.profiler device time, 20
calls). `python tools/torch_cli_profile.py sweep-tiles` builds its copies
(the kernel at other launch shapes) the same way. Every line is JSON and
names the card (`nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from typing import Callable

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(HERE, "focr_tpu_torch")
PROBE_DIR = os.path.join(PKG, "_build", "probes")
SOURCE = os.path.join("focr_tpu_torch", "csrc", "ncc_sweep.cu")

STAMP_DEFS = '''__device__ unsigned long long g_prof[16];
#define STAMP(k) do { if (tid == 0) { const long long _t = clock64(); \\
    atomicAdd(&g_prof[k], (unsigned long long)(_t - t_last)); t_last = _t; } } while (0)
'''
STAMP_NAMES = ("prologue", "chunk: stores, band, barrier", "A and sums", "first issue, terms",
               "later issues", "wgmma wait", "epilogues", "tiles' end", "barrier")
# (old, new) edits a probe makes; each old text must occur exactly once
PROBES = {
    "base": [],
    "tensor-x2": [(
        "wgmma_u8(d, a[s], b_desc(base + s * WG_N * 32), s > 0);",
        "wgmma_u8(d, a[s], b_desc(base + s * WG_N * 32), s > 0);\n#pragma unroll\n"
        "    for (int s = 0; s < NK; ++s) wgmma_u8(d, a[s], b_desc(base + s * WG_N * 32), 1);")],
    "epilogue-half": [(
        "        for (int j = 7; j >= 0; --j) group_j(j);",
        "        for (int j = 7; j >= 4; --j) group_j(j);")],
    "no-stores": [(
        "mask[((static_cast<size_t>(b) * T + t0 + n) * Hs + y0 + r) * NW + g0 + wd] =\n"
        "                    static_cast<int32_t>(v);",
        "if (v == 0x12345678u) mask[0] = 1;")],
    "store-signed": [(
        "            const unsigned u = static_cast<unsigned>(i), j = u % PER;\n"
        "            const int n = u / PER, r = j / WPC, wd = j % WPC;",
        "            const int n = i / PER, j = i % PER;\n"
        "            const int r = j / WPC, wd = j % WPC;")],
    "stamps": [
        ("// cp.async: copies to shared memory that no register waits on",
         STAMP_DEFS + "// cp.async: copies to shared memory that no register waits on"),
        ('extern "C" int focr_ncc_sweep(const void* imgs',
         'extern "C" int focr_prof_read(void* out)\n{\n'
         "    const cudaError_t e = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));\n"
         "    unsigned long long z[16] = {};\n"
         "    cudaMemcpyToSymbol(g_prof, z, sizeof(z));\n"
         "    return static_cast<int>(e);\n}\n\n"
         'extern "C" int focr_ncc_sweep(const void* imgs'),
        ("    const uint32_t bs_addr = static_cast<uint32_t>(__cvta_generic_to_shared(bs));\n",
         "    long long t_last = clock64();\n"
         "    const uint32_t bs_addr = static_cast<uint32_t>(__cvta_generic_to_shared(bs));\n"),
        ("    for (int i = tid; i < nb * ROWS; i += WG_THREADS) cnt_s[i] = 0;\n",
         "    for (int i = tid; i < nb * ROWS; i += WG_THREADS) cnt_s[i] = 0;\n    STAMP(0);\n"),
        ("// the band is in; the last chunk's stores are done with stage\n",
         "// the band is in; the last chunk's stores are done with stage\n        STAMP(1);\n"),
        ("            issue<KA, NKS>(acc, a, nks, bs_addr, 0);",
         "            STAMP(2);\n            issue<KA, NKS>(acc, a, nks, bs_addr, 0);"),
        ("            vmask |= __shfl_xor_sync(0xffffffffu, vmask, 16);",
         "            vmask |= __shfl_xor_sync(0xffffffffu, vmask, 16);\n            STAMP(3);"),
        ("                if (c > 0) issue<KA, NKS>(acc, a, nks, bs_addr, c);\n"
         "                wg_wait<0>();",
         "                if (c > 0) issue<KA, NKS>(acc, a, nks, bs_addr, c);\n"
         "                STAMP(4);\n                wg_wait<0>();\n                STAMP(5);"),
        ("                                       vmask, thr_eps, inv_n, wt, st, gq, tq);\n"
         "            }",
         "                                       vmask, thr_eps, inv_n, wt, st, gq, tq);\n"
         "                STAMP(6);\n            }\n"
         "            if (tid == 0) atomicAdd(&g_prof[11], 1ull);"),
        ("        __syncthreads();  // every tile of the chunk is done with its band, stage",
         "        STAMP(7);\n"
         "        __syncthreads();  // every tile of the chunk is done with its band, stage"),
        ("// every tile of the chunk is done with its band, stage and table\n",
         "// every tile of the chunk is done with its band, stage and table\n        STAMP(8);\n"),
    ],
}


def applied(name: str, edits: list[tuple[str, str]]) -> Callable[[str], str]:
    """A source edit that makes each (old, new) replacement; each old text
    must occur exactly once."""

    def edit(src: str) -> str:
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"probe {name}: its edit does not apply: {old[:60]!r}")
            src = src.replace(old, new)
        return src

    return edit


def make(name: str, edits: dict[str, Callable[[str], str]]) -> str:
    """The probe's copy of the package with ``edits`` (path in the repo ->
    source edit) applied, not yet built; returns its root."""
    root = os.path.join(PROBE_DIR, name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(PKG, os.path.join(root, "focr_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copytree(os.path.join(HERE, "tests", "fixtures"),
                    os.path.join(root, "tests", "fixtures"))
    for rel, edit in edits.items():
        path = os.path.join(root, rel)
        with open(path) as f:
            src = f.read()
        with open(path, "w") as f:
            f.write(edit(src))
    return root


def build_all(roots: list[str], at_once: int = 4) -> None:
    """Build each probe's kernels, ``at_once`` copies together (each build
    runs one nvcc a source)."""
    cmd = [sys.executable, "-c", "from focr_tpu_torch.native import build; build.build()"]
    for i in range(0, len(roots), at_once):
        procs = [subprocess.Popen(cmd, cwd=r, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for r in roots[i : i + at_once]]
        for r, p in zip(roots[i : i + at_once], procs):
            out = p.communicate(timeout=900)[0]
            if p.returncode != 0:
                raise RuntimeError(f"probe build in {r} failed: {out[-3000:]}")


def run_measure(name: str, root: str, exact: bool) -> dict:
    """measure() in the probe's own process; returns its JSON line."""
    res = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", name,
                          *(["--exact"] if exact else [])],
                         cwd=root, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"probe {name} failed: {res.stderr[-2000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def measure(name: str, exact: bool) -> None:
    """In the probe's own process (cwd = its root): K1's device ms/page by
    needle group, each group's mask and row counts first held bit for bit
    against the plain version where ``exact``; the stamps probe adds its
    cycles a tile by phase."""
    import ctypes

    import numpy as np
    import torch

    sys.path.insert(0, os.getcwd())
    from torch.profiler import ProfilerActivity, profile

    from focr_tpu_torch.fonts.bank import load_needle_bank
    from focr_tpu_torch.models import ncc as ncc_model
    from focr_tpu_torch.native import build
    from focr_tpu_torch.ops import ncc_kernels as K

    fixture = os.path.join("tests", "fixtures", "torch_ncc_golden.npz")
    with np.load(fixture, allow_pickle=False) as z:
        pages = z["pages"][: ncc_model.WAVE]
    inv = (255 - pages.astype(np.int16)).astype(np.uint8)
    groups = ncc_model._group_needles(load_needle_bank(fixture)[0])
    y0, x0, Hc, Wc = ncc_model._ink_crop(inv, *inv.shape[1:], groups)
    x = torch.from_numpy(np.ascontiguousarray(inv[:, y0 : y0 + Hc, x0 : x0 + Wc])).cuda()
    B = x.shape[0]
    with open(SOURCE) as f:
        consts = dict(re.findall(r"constexpr int (ROWS|COLS|WG_N) = (\d+);", f.read()))
    out = {"probe": name, "rows_cols_n": [int(consts[k]) for k in ("ROWS", "COLS", "WG_N")]}
    for g in groups:
        dg = ncc_model.group_from_numpy(g.bank, g.s_n, g.s2_n, 0.8, x.device)
        args = (x, dg.bank, dg.s_n, dg.s2_n, 0.8)
        call = lambda: K.ncc_sweep(*args, terms=dg.terms, packed=dg.packed)  # noqa: E731
        mask, rcnt = call()
        if exact:
            mask_r, rcnt_r = K.ncc_sweep_reference(*args, terms=dg.terms)
            if not (torch.equal(mask, mask_r) and torch.equal(rcnt, rcnt_r)):
                raise AssertionError(f"K1 differs from its plain version ({g.nw}x{g.nh})")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                call()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if "focr_ncc_sweep" in e.key]
        us = sum(getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
                 for e in evs)
        out[f"{g.nw}x{g.nh}_device_ms"] = us / max(1, sum(e.count for e in evs)) / 1e3 / B
        if name == "stamps":
            lib = build.load()
            lib.focr_prof_read.argtypes = [ctypes.c_void_p]
            buf = (ctypes.c_ulonglong * 16)()
            lib.focr_prof_read(buf)  # clear, then one call
            call()
            torch.cuda.synchronize()
            lib.focr_prof_read(buf)
            tiles = max(1, buf[11])
            out[f"{g.nw}x{g.nh}_cycles_a_tile"] = {n: round(buf[i] / tiles, 1)
                                                   for i, n in enumerate(STAMP_NAMES)}
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps(out), flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--measure"]:
        measure(sys.argv[2], "--exact" in sys.argv[3:])
        return 0
    names = sys.argv[1:] or list(PROBES)
    for name in names:
        if name not in PROBES:
            raise SystemExit(f"unknown probe {name}; probes: {', '.join(PROBES)}")
    roots = [make(name, {SOURCE: applied(name, PROBES[name])}) for name in names]
    build_all(roots)
    for name, root in zip(names, roots):
        print(json.dumps(run_measure(name, root, exact=name == "base")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
