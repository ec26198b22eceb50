"""The port's scripts, each run as ``python -m omnigs_torch.scripts.<name>``:
the copies of the benchmark scripts that hold TPU kernels
(`reduce_bench`, `bucket_emit_bench`, `kernel_ablate`), each with its
hand-written CUDA kernel and the kernel's plain PyTorch version; the
dataset tools (`make_synthetic_scene`, `dataset_to_openmvg`,
`run_benchmark`, `psnr_gate`); `scaling_bench`, the sharded step's
throughput over meshes; and `pool_bench`, `ImagePool`'s native pool
against its thread pool."""
