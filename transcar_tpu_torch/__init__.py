"""transcar_tpu_torch — the TransCAR detector in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package ``transcar_tpu`` beside it is the reference: each module
here sits at the same path as its JAX counterpart and is held against it
by the CPU parity tests (``tests/test_torch_*.py``).  This package imports
``torch`` and never ``jax``.

Layering (bottom → top): ``core`` → ``ops`` (plain versions and the
kernel wrappers; kernel sources in ``csrc/``) → ``models`` → ``eval`` /
``train`` → ``cli``.
"""
