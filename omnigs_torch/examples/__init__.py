"""The port's copies of the JAX package's command-line programs
(`examples/`), each run as ``python -m omnigs_torch.examples.<name>``
with the same arguments, plus ``--device``."""
