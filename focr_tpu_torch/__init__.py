"""focr_tpu_torch — the PyTorch + CUDA port of focr_tpu, for NVIDIA Hopper.

focr_tpu (JAX, TPU) is the reference; this package keeps its module layout and
names, imports torch and never jax, and shares no code with it.

  fonts/     host font layer: ctypes FreeType + the ncc needle bank
  ops/       device ops: window stats, the NCC sweep and compaction kernels
  csrc/      the hand-written CUDA C++ kernels (sm_90a)
  native/    nvcc build + ctypes binding of csrc/
  models/    the ncc matcher and hit post-processing
  io/        page I/O (PGM/PPM in NumPy), synthetic pages
  cli/       the ncc command line
  oracle/    the NumPy ncc oracle (differential check, --rust)
  utils/     device selection

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
