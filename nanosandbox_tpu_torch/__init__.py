"""PyTorch/CUDA port of nanosandbox_tpu, slice by slice.

This package imports ``torch`` and never ``jax`` or ``nanosandbox_tpu``:
the JAX package beside it is the reference its tests hold it against,
and anything it needs from there is kept here as its own copy. Module
paths mirror the JAX package's, so ``nanosandbox_tpu/serve/engine.py``
has its counterpart at ``nanosandbox_tpu_torch/serve/engine.py``.

The slice ported so far is the paged serving path: GPT-2 forward with a
block-paged KV pool, the two paged-attention kernels (CUDA C++ for
sm_90a, ``csrc/paged_attention.cu``), the continuous-batching engine and
its HTTP front end. Entry points run on the GPU unless the caller asks
for the CPU (``device="cpu"``), where every kernel wrapper runs its plain
PyTorch version instead.
"""

__version__ = "0.1.0"
