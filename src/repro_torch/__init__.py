"""PyTorch/CUDA port of ``repro`` for one NVIDIA H100: the serving paths
(static and paged continuous batching, f32 or int8 weights and KV pools,
under the fault-tolerant ``serve.supervisor``), single-device training
(``train.step``), ResNet-18 on the VTA kernels and the cluster planner.

The package mirrors ``repro``'s module and function names so each
counterpart is easy to find, imports ``torch`` and numpy only, and keeps
its own copies of what it needs (``configs``, ``optim.quant``, ``core``,
``ft.health``, ``data.pipeline``).  Attention
and the int8 GEMMs run through hand-written CUDA kernels
(``kernels/csrc``) on CUDA tensors and through their plain PyTorch
versions on CPU tensors.
"""
