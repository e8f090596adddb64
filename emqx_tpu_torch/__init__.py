"""PyTorch/CUDA port of the emqx_tpu match plane.

The reference is the JAX package ``emqx_tpu``; this package imports none
of it.  Entry points put their tensors on CUDA unless the caller passes
``device="cpu"``, which runs the plain PyTorch versions of the kernels.
"""

__version__ = "0.1.0"
