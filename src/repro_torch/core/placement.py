"""Pipeline cut points for a model's layer stack (the port's part of
``repro.core.placement``).

Only the backend-free half is here: :func:`pipeline_boundaries` (config
-> per-layer cost graph -> min-max DP, in the runtime's cut units) and
its helper :func:`_fold_groups`, which ``scheduler.recut_boundaries``
uses.  The reference's ``Placement.param_specs`` and ``to_placement``
lower a plan onto a device mesh's shardings; they come with the port's
distributed runtime.
"""

from __future__ import annotations

from repro_torch.core.partition import layer_costs, partition_layers


def _fold_groups(costs, group_size: int):
    """Fold per-layer costs into shared-attention-group costs (the
    runtime's cut unit for attn_every hybrids)."""
    if group_size <= 1:
        return costs
    if len(costs) % group_size:
        raise ValueError("num_layers % attn_every != 0")
    return [
        sum(costs[i : i + group_size])
        for i in range(0, len(costs), group_size)
    ]


def pipeline_boundaries(
    cfg, seq_len: int, stages: int, stage_weights=None
) -> tuple[int, ...]:
    """Cost-balanced cut points for ``cfg``'s stack, in the RUNTIME's
    cut units: layers for homogeneous decoder stacks, shared-attention
    groups for ``attn_every`` hybrids.  The one-stop recipe the
    launchers use: config -> per-layer cost graph -> min-max DP.
    """
    from repro_torch.core.graph import config_graph

    costs = _fold_groups(
        layer_costs(config_graph(cfg, seq_len)), cfg.attn_every or 1
    )
    return partition_layers(costs, stages, stage_weights=stage_weights)
