"""The runtime for the paper's cluster plans (the port of ``repro.dist``).

``repro_torch.core.strategies`` decides *how* to spread a workload over
the cluster (scatter-gather DP, AI-core operator assignment, pipeline,
fused); this package makes those decisions executable:

  sharding  — the spec engine: strategy -> per-leaf specs over a device
              mesh, spec repair against an actual mesh, and ``place``
  pipeline  — GPipe / 1F1B pipeline over the mesh's ``model`` axis with
              uneven contiguous stage cuts

Submodules are imported directly (``from repro_torch.dist.sharding import
param_specs``): ``pipeline`` depends on ``repro_torch.models``.
"""
