"""Pipeline schedules over the mesh's 'model' axis (the port of
``repro.dist.pipeline``).

The paper's pipeline strategy cuts the NN graph into contiguous
segments, one node per segment, and streams inputs through the pipe —
and its headline knob is that the cuts need NOT be even: the cluster
"manually allocates greater resources to the most computationally
intensive layers".  This module executes exactly that:

**Uneven contiguous cuts.**  ``boundaries`` (from
:func:`repro_torch.core.partition.partition_layers`, surfaced through
``Placement.layer_boundaries``) assign stage *k* the layer slice
``[boundaries[k], boundaries[k+1])``.  Stored params keep the reference's
padded layout: every stage's slice is padded to the deepest stage's
layer count (:func:`pad_pipeline_params`), so the block list has
``stages * max_depth * per`` entries and stage k owns the k-th equal
slice.  Padding rows are clones of the stage's last real layer that the
executors never run: they get exactly zero gradient.

**Execution.**  One process drives a row's stages.  Stage k's layers run
on the device of the row's k-th 'model' column (every column of a mesh
that lists one card several times is that card); activations move to
the next stage with ``.to()``.  Without a data group the data axis runs
in the same process: each microbatch's rows are split over the data
shards where ``fix_spec`` keeps the split, each shard runs its own
units, and the shards' gradients and losses are averaged in shard order,
as the reference's ``pmean`` does.  With one (one process per data
position, ``dist.collective``) each process runs its own shard on its
own row, and the train step averages across processes.

**Schedules.**  The forward pipe is fill-and-drain (``m + S - 1``
rounds).  The pipelined train loop (:func:`make_pipeline_loss_and_grad`)
runs one round body for both schedules; they differ only in the lag
between the forward stream and the backward stream:

  gpipe  lag = m + S - 1   backward fills only after the forward fully
                           drains — 2(m + S - 1) rounds total
  1f1b   lag = S - 1       the backward of microbatch i starts the
                           round its forward finishes at the last
                           stage — m + 2(S - 1) rounds total

Each stage does the same operations on the same values in the same
order under both schedules, so their losses and gradients are bitwise
equal.  A stage-round with no unit scheduled executes nothing (the
reference's SPMD lockstep runs masked compute there); each executor
records which stage-rounds did work in its ``counts`` attribute —
``(rounds, busy, idle)`` of its last call, the numbers
:func:`pipeline_bubble_counts` predicts.

**Hybrid stacks** (``attn_every``, zamba2-style) pipeline at the *group*
boundary: a cut unit is ``attn_every`` Mamba layers plus the shared
attention block, whose params every stage uses.

Embedding and the LM head run outside the pipe for the forward; the
train pipe folds final-norm + head + chunked CE into the last stage
(1F1B needs the loss gradient mid-loop).

MoE capacity: router capacity buffers are sized from the **global**
batch token count, so a pipelined MoE run matches the full-batch forward
whenever the full-batch run is below capacity; over capacity, which
tokens drop still differs (a warning says so when the pipe is built).
"""

from __future__ import annotations

import warnings

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.partition import (  # noqa: F401  (bubble oracle re-export)
    even_boundaries,
    pipeline_bubble_counts,
    stage_depths,
)
from repro_torch.dist.collective import shard_rows
from repro_torch.dist.sharding import (
    MDL,
    _axis_size,
    _dp,
    _place_all,
    fix_spec,
    local_mesh,
    stage_devices,
)
from repro_torch.models import transformer as tf
from repro_torch.models.layers import dense_apply, embedding_logits, rmsnorm_apply
from repro_torch.models.moe import capacity_for
from repro_torch.train.step import chunked_ce
from repro_torch.tree import leaves, tree_map, unflatten


def num_stages(mesh) -> int:
    return mesh.shape.get(MDL, 1)


def pipeline_units(cfg) -> int:
    """Number of cut units in the stack: layers for homogeneous decoder
    stacks, shared-attention *groups* for hybrids (cuts between a group's
    Mamba layers would strand its shared block mid-stage)."""
    if cfg.is_enc_dec:
        raise NotImplementedError(
            "pipeline runtime covers decoder stacks; "
            f"{cfg.name} is encoder-decoder"
        )
    if cfg.attn_every:
        if cfg.num_layers % cfg.attn_every:
            raise ValueError("num_layers % attn_every != 0")
        return cfg.num_layers // cfg.attn_every
    return cfg.num_layers


def _resolve_boundaries(cfg, stages: int, boundaries) -> tuple[int, ...]:
    units = pipeline_units(cfg)
    if boundaries is None:
        boundaries = even_boundaries(units, stages)
    boundaries = tuple(int(b) for b in boundaries)
    if len(boundaries) != stages + 1:
        raise ValueError(
            f"{len(boundaries)} boundaries for {stages} stages "
            f"(want stages + 1)"
        )
    if boundaries[-1] != units:
        raise ValueError(
            f"boundaries end at {boundaries[-1]}, stack has {units} units"
        )
    stage_depths(boundaries)  # validates monotonicity from 0
    return boundaries


def pad_pipeline_params(params, cfg, boundaries):
    """Pad ``params['blocks']`` to the per-stage layout the executors
    expect: ``stages * max_depth * per`` entries, stage *k*'s slice
    holding its real layers followed by clones of its last real layer
    (never run, zero gradient).  The real layers are the input's own
    subtrees; each padding row is a new tensor, so no leaf appears twice
    in the tree.  Identity when the cuts are already even.  Works on
    tensors of any device, ``meta`` included.
    """
    boundaries = tuple(int(b) for b in boundaries)
    depths = stage_depths(boundaries)
    max_d = max(depths)
    if all(d == max_d for d in depths):
        return params
    per = cfg.attn_every or 1
    blocks = params["blocks"]
    rows = []
    for s, d in enumerate(depths):
        for j in range(max_d):
            unit = boundaries[s] + min(j, d - 1)
            for r in range(per):
                layer = blocks[unit * per + r]
                rows.append(layer if j < d else tree_map(torch.clone, layer))
    return dict(params, blocks=rows)


def unpad_pipeline_params(params, cfg, boundaries):
    """Inverse of :func:`pad_pipeline_params`: recover the canonical
    ``num_layers`` block list from the padded per-stage one.

    Stage *k*'s slice holds its real layers first (rows ``j < depth_k``
    of ``k * max_depth + j``); the trailing rows are padding, so dropping
    them is exact.  The canonical layout is what checkpoints store
    (topology-independent restore) and what a live re-cut re-pads from.
    """
    boundaries = tuple(int(b) for b in boundaries)
    depths = stage_depths(boundaries)
    max_d = max(depths)
    if all(d == max_d for d in depths):
        return params
    per = cfg.attn_every or 1
    blocks = params["blocks"]
    rows = [blocks[(s * max_d + j) * per + r]
            for s, d in enumerate(depths) for j in range(d) for r in range(per)]
    return dict(params, blocks=rows)


def _check_padded(blocks, stages: int, max_d: int, per: int) -> None:
    want = stages * max_d * per
    if len(blocks) != want:
        raise ValueError(
            f"params['blocks'] has {len(blocks)} layers != {want} "
            f"(= stages {stages} x max stage depth {max_d} x {per}); "
            "pad uneven cuts with pad_pipeline_params(params, cfg, "
            "boundaries) before running the pipe"
        )


def _stage_layers(blocks, depths, max_d: int, per: int) -> list:
    """Each stage's real layers (padding rows skipped), in order."""
    return [blocks[k * max_d * per:(k * max_d + d) * per] for k, d in enumerate(depths)]


def _moe_global_capacity(cfg, global_tokens: int) -> int | None:
    """Capacity per expert sized from the GLOBAL batch token count — the
    same formula ``moe_apply`` derives for the full-batch forward, so
    pipelined microbatches can never overflow unless the full-batch run
    would.  ``transformer._ffn_apply`` clamps it to each call's own token
    count, which cannot introduce drops."""
    if not cfg.moe_experts:
        return None
    return capacity_for(cfg, global_tokens)


def _warn_moe_over_capacity(cfg) -> None:
    if cfg.moe_experts:
        warnings.warn(
            f"pipelined MoE ({cfg.name}): router capacity buffers are "
            "sized from the global batch, so results match the "
            "full-batch forward below capacity; an over-capacity router "
            "still drops different tokens than the full-batch forward "
            "(per-microbatch cumsum order)",
            stacklevel=3,
        )


def _make_run_stage(cfg, moe_cap, remat: bool = False):
    """Stage-local layer runner ``run(layers, x, shared) -> (y, aux_sum)``
    over a stage's real layers.  ``remat`` checkpoints each layer (and a
    hybrid's shared block), so a backward unit keeps one activation per
    layer, not every within-layer intermediate."""

    def call(fn, *args):
        return checkpoint(fn, *args, use_reentrant=False) if remat else fn(*args)

    per = cfg.attn_every

    def run(layers, x, shared=None):
        positions = tf._positions(0, x)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for li, p in enumerate(layers):
            x, _, a = call(tf.block_apply, p, cfg, x, positions, None, moe_cap)
            if a is not None:
                aux = aux + a
            if per and (li + 1) % per == 0:
                x, _ = call(tf._shared_block, shared, cfg, x, positions, None)
        return x, aux

    return run


class _Rounds:
    """Which stage did a unit in which round: ``(rounds, busy, idle)``."""

    def __init__(self, stages: int, rounds: int):
        self.stages, self.rounds = stages, rounds
        self.busy = set()

    def mark(self, stage: int, t: int) -> None:
        self.busy.add((stage, t))

    def counts(self) -> tuple[int, int, int]:
        busy = len(self.busy)
        return self.rounds, busy, self.stages * self.rounds - busy


def _data_shards(mesh, m: int, mb: int, s: int, d: int) -> int:
    """The data shards a microbatch's rows split into: the effective count
    after ``fix_spec`` (1 when the microbatch does not divide the data
    axes, which then replicate it)."""
    io = fix_spec((None, _dp(mesh)), (m, mb, s, d), mesh)
    return _axis_size(mesh, io[1])


# ---------------------------------------------------------------------------
# forward (inference / equivalence) pipeline — fill-and-drain
# ---------------------------------------------------------------------------


def make_pipeline_forward(cfg, mesh, num_microbatches: int = 8, boundaries=None):
    """Build ``fwd(params, tokens, embeds=None) -> logits`` running the
    layer stack as a ``mesh.shape['model']``-stage fill-and-drain
    pipeline.

    ``boundaries`` are contiguous layer (group, for hybrids) cut points
    from the planner; None cuts by layer count.  Uneven cuts require
    params padded with :func:`pad_pipeline_params`.  Needs
    ``batch % num_microbatches == 0``; enc-dec stacks are not supported.
    ``fwd.counts`` is ``(rounds, busy, idle)`` of the last call.
    """
    stages = num_stages(mesh)
    bounds = _resolve_boundaries(cfg, stages, boundaries)
    depths = stage_depths(bounds)
    max_d = max(depths)
    per = cfg.attn_every or 1
    m = num_microbatches
    if m < 1:
        raise ValueError("need at least one microbatch")
    _warn_moe_over_capacity(cfg)
    devices = stage_devices(mesh)

    def fwd(params, tokens, embeds=None):
        x = tf._embed(params, cfg, tokens, embeds)
        b, s, d = x.shape
        if b % m:
            raise ValueError(f"batch {b} not divisible by {m} microbatches")
        _check_padded(params["blocks"], stages, max_d, per)
        run = _make_run_stage(cfg, _moe_global_capacity(cfg, b * s))
        mb = b // m
        ndp = _data_shards(mesh, m, mb, s, d)
        r = mb // ndp
        layers = _stage_layers(params["blocks"], depths, max_d, per)
        shared = [_place_all(params.get("shared_attn"), dev) for dev in devices]
        sched = _Rounds(stages, m + stages - 1)
        acts, outs = {}, [None] * m
        for t in range(m + stages - 1):
            for k in range(stages):
                i = t - k
                if not 0 <= i < m:
                    continue
                if k == 0:
                    xin = [x[i * mb + j * r:i * mb + (j + 1) * r] for j in range(ndp)]
                else:
                    xin = acts.pop((k, i))
                ys = [run(layers[k], xj.to(devices[k]), shared[k])[0] for xj in xin]
                if k == stages - 1:
                    outs[i] = ys
                else:
                    acts[(k + 1, i)] = ys
                sched.mark(k, t)
        fwd.counts = sched.counts()
        dev = params["final_norm"]["scale"].device
        y = torch.cat([yj.to(dev) for ys in outs for yj in ys], dim=0)
        return tf._head(params, cfg, y)

    fwd.counts = None
    return fwd


# ---------------------------------------------------------------------------
# pipelined train loss/grad — gpipe vs 1f1b round loop
# ---------------------------------------------------------------------------


def _grad(outputs, seeds, inputs):
    """``torch.autograd.grad`` with a zero for an input the outputs do not
    reach, as ``jax.vjp`` gives."""
    grads = torch.autograd.grad(outputs, inputs, seeds, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g for x, g in zip(inputs, grads)]


def _leaves_grad(tree):
    """Fresh leaves of ``tree`` that require grad, and the tree over them."""
    flat = [x.detach().requires_grad_() for x in leaves(tree)]
    return flat, unflatten(tree, flat)


def make_pipeline_loss_and_grad(cfg, mesh, num_microbatches: int = 8,
                                boundaries=None, schedule: str = "1f1b",
                                aux_weight: float = 0.01, remat: bool = True,
                                group=None):
    """Build ``loss_and_grad(params, batch) -> ((loss, metrics), grads)``
    with microbatch gradient accumulation *through* the pipe.

    Per round every stage executes the forward unit and the backward
    unit its schedule gives it, if any.  A forward unit runs the stage on
    its input without a graph and stashes the input; on the last stage it
    then seeds the token-mean chunked CE of the finished microbatch
    (final norm + LM head) and its dY with ``1 / m``.  A backward unit
    re-runs the stage from the stash (per-layer ``checkpoint`` when
    ``remat``), seeds the stage's aux with ``aux_weight / m``, and takes
    the grads of the stage's real layers and of its input, accumulated in
    f32 in ascending microbatch order.  The embedding runs outside the
    pipe, its grad fed by the dX leaving stage 0; a tied table's grad is
    the lookup's plus the head's.  ``grads['blocks']`` comes out padded
    like the params, padding rows exactly zero.

    ``schedule``: ``'gpipe'`` (backward starts after the forward drains)
    or ``'1f1b'`` (backward lags the forward by ``stages - 1`` rounds) —
    bitwise-identical results, fewer idle stage-rounds for 1f1b per
    :func:`pipeline_bubble_counts`.  ``loss_and_grad.counts`` is
    ``(rounds, busy, idle)`` of the last call.  Homogeneous token-only
    decoder stacks.

    With a ``group`` (one process per data position) the data axis runs
    across processes: the process takes its data shard of the GLOBAL
    batch (``dist.collective.shard_rows``; shard ``p // (count / ndp)``
    where the microbatch splits in ``ndp`` effective shards) through the
    stages of its own row (``dist.sharding.local_mesh``) and returns that
    shard's loss and grads; ``train.step.make_pipeline_train_step``
    averages them across processes.
    """
    stages = num_stages(mesh)
    if cfg.attn_every or cfg.is_enc_dec:
        raise NotImplementedError(
            "pipelined train covers homogeneous decoder stacks; "
            f"{cfg.name} interleaves shared/cross blocks"
        )
    if cfg.frontend:
        raise NotImplementedError(
            "pipelined train is token-only; "
            f"{cfg.name} takes {cfg.frontend} embeddings"
        )
    if schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"unknown schedule {schedule!r}")
    bounds = _resolve_boundaries(cfg, stages, boundaries)
    depths = stage_depths(bounds)
    max_d = max(depths)
    m = num_microbatches
    if m < 1:
        raise ValueError("need at least one microbatch")
    _warn_moe_over_capacity(cfg)
    lag = (stages - 1) if schedule == "1f1b" else (m + stages - 1)
    rounds = lag + m + stages - 1
    tied = cfg.tie_embeddings
    # across processes the rows are split before the pipe, which then runs
    # on this process's row: one data shard
    row_mesh = local_mesh(mesh, group) if group is not None else mesh
    devices = stage_devices(row_mesh)
    f32 = torch.float32

    def head_loss(hp, y, tg):
        # chunked fused CE (as the unpipelined loss): the (mb, chunk,
        # vocab) f32 logits exist one chunk at a time, in the backward too
        h = rmsnorm_apply(hp["final_norm"], y, cfg.norm_eps)
        if tied:
            return chunked_ce(lambda hh: embedding_logits(hp["embed"], hh), h, tg)
        return chunked_ce(lambda hh: dense_apply(hp["lm_head"], hh), h, tg)

    def shard_units(layers, head, run, xs, ts, sched):
        """One data shard through the schedule: per-stage f32 layer grads,
        f32 head grads, the dX of each microbatch, the CE and each
        stage's aux sum."""
        last = stages - 1
        stash = [dict() for _ in range(stages)]
        fq, bq, dhq, dxq = {}, {}, {}, [None] * m
        gblocks = [[torch.zeros(p.shape, dtype=f32, device=p.device) for p in leaves(ls)]
                   for ls in layers]
        ghead = [torch.zeros(p.shape, dtype=f32, device=p.device) for p in leaves(head)]
        ce_acc = torch.zeros((), dtype=f32, device=devices[last])
        aux_acc = [torch.zeros((), dtype=f32, device=dev) for dev in devices]
        for t in range(rounds):
            for k in range(stages):
                # ---- forward unit: microbatch t - k
                i = t - k
                if 0 <= i < m:
                    x_in = (xs[i] if k == 0 else fq.pop((k, i))).to(devices[k])
                    stash[k][i] = x_in
                    with torch.no_grad():
                        y, a = run(layers[k], x_in)
                    aux_acc[k] = aux_acc[k] + a
                    if k == last:
                        # loss seed: CE of the finished microbatch + its dY
                        hflat, hp = _leaves_grad(head)
                        yg = y.detach().requires_grad_()
                        with torch.enable_grad():
                            ce = head_loss(hp, yg, ts[i].to(devices[k]))
                            g = _grad([ce], [torch.tensor(1.0 / m, dtype=f32, device=ce.device)],
                                      hflat + [yg])
                        ce_acc = ce_acc + ce.detach() / m
                        ghead = [acc + dg.float() for acc, dg in zip(ghead, g[:-1])]
                        dhq[i] = g[-1].to(x_in.dtype)
                    else:
                        fq[(k + 1, i)] = y
                    sched.mark(k, t)
                # ---- backward unit: microbatch t - lag - (S - 1 - k),
                # recomputed from the stashed stage input
                i = t - lag - (last - k)
                if 0 <= i < m:
                    x_j = stash[k].pop(i)
                    dy = dhq.pop(i) if k == last else bq.pop((k, i))
                    lflat, lp = _leaves_grad(layers[k])
                    xg = x_j.detach().requires_grad_()
                    with torch.enable_grad():
                        y, a = run(lp, xg)
                        outs, seeds = [y], [dy.to(y.device)]
                        if a.requires_grad:
                            outs.append(a)
                            seeds.append(torch.tensor(aux_weight / m, dtype=f32,
                                                      device=a.device))
                        g = _grad(outs, seeds, lflat + [xg])
                    gblocks[k] = [acc + dg.float() for acc, dg in zip(gblocks[k], g[:-1])]
                    if k == 0:
                        dxq[i] = g[-1]
                    else:
                        bq[(k - 1, i)] = g[-1]
                    sched.mark(k, t)
        return gblocks, ghead, dxq, ce_acc, aux_acc

    def loss_and_grad(params, batch):
        if group is not None:
            b = batch["tokens"].shape[0]
            ndp = _data_shards(mesh, m, b // m, batch["tokens"].shape[1] - 1, cfg.d_model)
            batch = shard_rows(batch, m, ndp, group.rank // (group.size // ndp))
        tokens = batch["tokens"]
        inp_tok, tgt = tokens[:, :-1], tokens[:, 1:]
        table = params["embed"]["table"].detach().requires_grad_()
        with torch.enable_grad():
            x = tf._embed({"embed": {"table": table}}, cfg, inp_tok)
        b, s, d = x.shape
        if b % m:
            raise ValueError(f"batch {b} not divisible by {m} microbatches")
        _check_padded(params["blocks"], stages, max_d, 1)
        run = _make_run_stage(cfg, _moe_global_capacity(cfg, b * s), remat=remat)
        mb = b // m
        # the dp factor that survives spec repair: a microbatch that does
        # not divide the data axes replicates, and the dX normalizer is
        # the EFFECTIVE shard count
        ndp = _data_shards(row_mesh, m, mb, s, d)
        r = mb // ndp
        layers = _stage_layers(params["blocks"], depths, max_d, 1)
        head_tree = {"final_norm": params["final_norm"]}
        if tied:
            head_tree["embed"] = params["embed"]
        else:
            head_tree["lm_head"] = params["lm_head"]
        head = _place_all(head_tree, devices[-1])
        xd = x.detach()
        sched = _Rounds(stages, rounds)
        shards = []
        for j in range(ndp):
            sl = [slice(i * mb + j * r, i * mb + (j + 1) * r) for i in range(m)]
            shards.append(shard_units(layers, head, run, [xd[q] for q in sl],
                                      [tgt[q] for q in sl], sched))
        loss_and_grad.counts = sched.counts()

        # reductions: per-shard grads are d(local-mean loss); the global
        # loss is the mean over data shards, so grads average over them
        # (summed in shard order, as a pmean); the head and the loss ran
        # on the last stage only, the dX left stage 0
        def mean(vals):
            total = vals[0]
            for v in vals[1:]:
                total = total + v
            return total / ndp if ndp > 1 else total

        gblocks = [[mean([sh[0][k][n] for sh in shards]) for n in range(len(shards[0][0][k]))]
                   for k in range(stages)]
        ghead = unflatten(head_tree, [mean([sh[1][n] for sh in shards]).to(p.device)
                                      for n, p in enumerate(leaves(head_tree))])
        ce = mean([sh[3] for sh in shards]).to(devices[0])

        def stage_sum(acc):
            total = acc[0]
            for a in acc[1:]:
                total = total + a.to(total.device)
            return total

        aux = mean([stage_sum(sh[4]) for sh in shards]) / m
        dx = torch.cat([sh[2][i] / ndp if ndp > 1 else sh[2][i]
                        for i in range(m) for sh in shards], dim=0)
        dx = dx.to(x.device).to(x.dtype)
        (d_table,) = _grad([x], [dx], [table])
        d_table = d_table.float()
        if tied:  # table grad: lookup (outside) + tied logits (in-pipe)
            d_table = d_table + ghead["embed"]["table"]
        gpad = []
        for k, dk in enumerate(depths):
            real = unflatten(layers[k], gblocks[k])
            for jj in range(max_d):
                row = params["blocks"][k * max_d + jj]
                gpad.append(real[jj] if jj < dk else
                            tree_map(lambda p: torch.zeros(p.shape, dtype=f32,
                                                           device=p.device), row))
        grads = {"blocks": gpad, "final_norm": ghead["final_norm"],
                 "embed": {"table": d_table}}
        if not tied:
            grads["lm_head"] = ghead["lm_head"]
        loss = ce + aux_weight * aux
        return (loss, {"ce": ce, "aux": aux}), grads

    loss_and_grad.counts = None
    return loss_and_grad
