"""The port's copies of the benchmark scripts that hold TPU kernels
(`scripts/reduce_bench.py`, `scripts/bucket_emit_bench.py`,
`scripts/kernel_ablate.py`), each with its hand-written CUDA kernel, the
kernel's plain PyTorch version and a `main` run as
``python -m omnigs_torch.scripts.<name>``."""
