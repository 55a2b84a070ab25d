"""PyTorch/CUDA port of the ``repro`` serving paths (static and paged
continuous batching, f32 or int8 weights and KV pools) for one NVIDIA
H100.

The package mirrors ``repro``'s module and function names so each
counterpart is easy to find, imports ``torch`` and numpy only, and keeps
its own copies of what it needs (``configs``, ``optim.quant``).  Attention
and the int8 GEMMs run through hand-written CUDA kernels
(``kernels/csrc``) on CUDA tensors and through their plain PyTorch
versions on CPU tensors.
"""
