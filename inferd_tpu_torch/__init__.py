"""inferd-tpu on PyTorch and CUDA: the port of `inferd_tpu` to an NVIDIA H100.

`inferd_tpu_torch/X.py` is the counterpart of `inferd_tpu/X.py`. The port
imports torch, numpy and the standard library only: nothing of JAX and
nothing of the JAX package. Its entry points run on the CUDA device unless
the caller asks for the CPU, where every kernel wrapper runs its plain
PyTorch version instead.
"""
