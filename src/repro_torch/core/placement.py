"""ClusterPlan -> runtime translation (the port of
``repro.core.placement``).

The bridge between the paper-faithful planner
(``repro_torch.core.strategies``) and the executable runtime layer:
``repro_torch.dist.sharding`` (the spec engine behind every launcher) and
``repro_torch.dist.pipeline`` (the pipeline schedules):

  scatter_gather      -> pure-DP specs (params replicated)
  ai_core_assignment  -> TP/EP specs (model axis on bottleneck ops)
  fused               -> FSDP x TP 2D specs
  pipeline            -> stage count + **uneven layer boundaries** +
                         microbatches + schedule for
                         ``make_pipeline_forward`` /
                         ``make_pipeline_loss_and_grad``

For the pipeline strategy the plan's cost-balanced op cuts are recovered
as layer boundaries (or re-derived with
:func:`repro_torch.core.partition.partition_layers` when the plan's
stage count does not match the mesh), so the planner's "more resources
to the most intensive layers" decision survives into the schedule.
:func:`pipeline_boundaries` is the launchers' recipe: config ->
per-layer cost graph -> min-max DP, in the runtime's cut units.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.partition import (
    layer_boundaries_from_plan,
    layer_costs,
    partition_layers,
    plan_num_layers,
)
from repro_torch.core.strategies import ClusterPlan


@dataclasses.dataclass(frozen=True)
class Placement:
    strategy: str
    #: strategy string accepted by repro_torch.dist.sharding.param_specs
    sharding_strategy: str
    #: pipeline configuration (None unless strategy == 'pipeline')
    pipeline_stages: int | None
    num_microbatches: int | None
    #: contiguous layer cut points (stages + 1 entries, 0 .. num_layers);
    #: None -> the runtime falls back to layer-count-balanced cuts
    layer_boundaries: tuple[int, ...] | None = None
    #: pipelined-train schedule: "gpipe" (fill-and-drain) or "1f1b"
    pipeline_schedule: str = "gpipe"

    def param_specs(self, params, mesh):
        from repro_torch.dist.sharding import param_specs

        return param_specs(params, mesh, self.sharding_strategy)


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


def to_placement(
    plan: ClusterPlan,
    mesh,
    num_microbatches: int = 8,
    *,
    graph=None,
    num_layers: int | None = None,
    schedule: str = "gpipe",
    group_size: int = 1,
) -> Placement:
    """Lower ``plan`` onto ``mesh`` (anything with a ``.shape`` axis ->
    size mapping).

    For pipeline plans the layer boundaries are taken from the plan's
    own op-granularity stage cuts when its stage count matches the
    mesh's 'model' axis; otherwise (mesh resized, plan from a different
    cluster width) they are re-balanced from the ``graph``'s per-layer
    costs via the same min-max DP the planner uses.  Without a graph the
    boundaries stay None and the runtime cuts by layer count.

    ``group_size`` (= ``cfg.attn_every`` for hybrid stacks) converts the
    graph's layer-granular costs to the runtime's group cut units; the
    plan's op-level cuts are skipped in that case, since they need not
    respect group boundaries.
    """
    if plan.strategy == "pipeline":
        stages = mesh.shape.get("model", 1)
        boundaries = None
        costs = None
        if graph is not None:
            try:
                costs = _fold_groups(layer_costs(graph), group_size)
            except ValueError:
                costs = None
        if num_layers is not None:
            n_layers = num_layers
        elif costs is not None:
            n_layers = len(costs)
        else:
            # no graph in hand: the plan's own layer{i}.* op names still
            # carry the layer count, so its uneven cuts survive
            n_layers = plan_num_layers(plan)
        if (group_size <= 1 and n_layers is not None
                and len(plan.stages) == stages):
            boundaries = layer_boundaries_from_plan(plan, n_layers)
        if boundaries is None and costs is not None and stages <= len(costs):
            boundaries = partition_layers(costs, stages)
        return Placement(
            strategy="pipeline",
            # blocks stage-split on the layer axis, embed/head off the
            # 'model' axis so the in-pipe loss head needs no gather
            sharding_strategy="pipeline",
            pipeline_stages=stages,
            num_microbatches=num_microbatches,
            layer_boundaries=boundaries,
            pipeline_schedule=schedule,
        )
    mapping = {
        "scatter_gather": "scatter_gather",
        "ai_core_assignment": "ai_core_assignment",
        "fused": "fused",
    }
    return Placement(
        strategy=plan.strategy,
        sharding_strategy=mapping[plan.strategy],
        pipeline_stages=None,
        num_microbatches=None,
    )
