"""The CUDA kernels' wrappers and their plain PyTorch versions.

Importing the package makes one call into MKL's vector math library
(VML), through which torch computes exp, log and erf on CPU tensors.
VML picks its code path once a process, at its first call, and two
intra-op threads that make that first call together race there: the
loser computed its whole share with the AVX2 enhanced-performance exp
(bit for bit ``vmsExp`` in ``VML_EP`` mode under
``MKL_ENABLE_INSTRUCTIONS=AVX2``), up to 1.5e-4 relative error, where
every later call is exact to float32. A one-element call runs on the
calling thread alone, so it settles the choice before any parallel one;
every module of the port that runs a model on the CPU imports this
package first.
"""

import torch as _torch

_torch.log(_torch.ones(1))
