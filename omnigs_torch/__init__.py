"""PyTorch/CUDA port of `omnigs_tpu`, module for module.

Every module here has one counterpart under `omnigs_tpu/` with the same
path and function names; the JAX package is the reference the port is
tested against (tests/test_torch_*.py). Plain tensor code is PyTorch; each
Pallas TPU kernel becomes a CUDA kernel for Hopper (`csrc/`), built from the
repository's sources at first use (`omnigs_torch/cuda_build.py`).

Device policy: entry points take an explicit ``device`` (default
``"cuda"``); a wrapper around a CUDA kernel runs its plain PyTorch version
only for tensors on the CPU, and launches the kernel (or raises) for CUDA
tensors. There is no silent CPU fallback.

Float32 policy, set once here for the whole package: float32 matrix
products and cuDNN convolutions run in full float32, never TF32 (the
reference computes `world_to_cam` and friends in f32; TF32 keeps ~3
decimal digits).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
