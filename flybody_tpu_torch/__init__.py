"""flybody_tpu_torch: the fly engine and its walking task in PyTorch + CUDA.

The PyTorch/CUDA counterpart of the JAX package `flybody_tpu`, laid out
like it (model/, utils/, physics/, ops/, envs/). Batched functions take
tensors with a leading env dimension; the smooth-dynamics hot stages run
as hand-written CUDA kernels (csrc/, bound in ops/) on CUDA tensors and as
their plain PyTorch versions on CPU tensors.
"""
