"""focr_tpu_torch — the PyTorch + CUDA port of focr_tpu, for NVIDIA Hopper.

focr_tpu (JAX, TPU) is the reference; this package keeps its module layout and
names, imports torch and never jax, and shares no code with it. It runs the
two binaries' main paths: `focr` (the monospace grid decoder and the
proportional greedy decoder) and `ncc` (the template matcher).

  fonts/     host font layer: ctypes FreeType, the focr grid and proportional
             banks and the ncc needle bank (all can be saved and loaded as .npz)
  ops/       device ops: the SSD-argmin and cursor-scan kernels (focr), window
             stats, the NCC sweep and compaction kernels (ncc), each beside its
             plain version
  csrc/      the hand-written CUDA C++ kernels (sm_90a)
  native/    nvcc build + ctypes binding of csrc/
  models/    the focr grid and proportional decoders, the ncc matcher and hit
             post-processing
  io/        page I/O (PNM and PNG in NumPy and zlib), page buckets, synthetic
             pages
  cli/       the focr and ncc command lines
  oracle/    the NumPy focr and ncc oracles
  utils/     device selection

For example, the canonical focr grid on a CUDA card (``--device cpu`` runs
the plain versions):

  python -m focr_tpu_torch.cli.focr -i page-*.pgm -f DejaVuSansMono.ttf
      -t 13 -x 45 -y 39 -w 608 --line-height 12 --line-advance 15

Importing the package pins every float32 matmul to full IEEE float32 (no TF32,
no reduced-precision reductions): the exactness contract holds the device's
integer-valued float sums to be exact.
"""

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
_torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
_torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"
