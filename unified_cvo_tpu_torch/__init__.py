"""PyTorch/CUDA port of unified_cvo_tpu for NVIDIA Hopper (H100).

The JAX package `unified_cvo_tpu` stays the reference; this package holds
the same algorithms in PyTorch, with the TPU's Pallas kernels rewritten as
hand-written CUDA C++ (sources under `csrc/`, built with nvcc at first use).
It imports neither `jax` nor anything of `unified_cvo_tpu`.

Float32 is kept everywhere the reference keeps it: TF32 is switched off for
matmuls and cuDNN here, as the JAX package pins HIGHEST matmul precision.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"
