"""Training step: loss, remat, grad accumulation, AdamW (PyTorch port of
``repro.train.step``, single device).

``make_train_step(cfg, opt_cfg)`` returns ``train_step(state, batch) ->
(state, metrics)``.  The state is ``{"params", "opt": adamw.OptState,
"step"}`` (plus ``"ef"`` with a compressor); a batch is ``{"tokens":
(B, S + 1)}`` (and ``"frames"`` for an enc-dec config, ``"embeds"`` for a
VLM), tensors on the params' device.

Grad accumulation runs the microbatches in order and sums their
gradients in f32 as the reference's scan carry does (``acc + g /
grad_accum``).  With ``remat`` every block is recomputed in the backward
(the models' ``remat`` flag), and the chunked cross-entropy recomputes
each chunk's logits, so the (B, S, vocab) logits never exist.  Attention
on the card runs the flash kernel forward in both the forward and the
remat recompute; its backward is the plain version's
(``kernels.flash_attention.FlashAttentionFunction``).

Across processes (``group``, ``model``): each data position computes on
its rows of every microbatch and the grads are averaged over the data
group; with a model group (one process per mesh position) the loss runs
tensor and expert parallel under ``dist.tensor.parallel`` (the chunked
CE's logits gathered whole inside each chunk's checkpoint, so the gather
runs again in the recompute), and MoE layers route each microbatch's
tokens across the data group (``models.moe``).

``make_pipeline_train_step`` is the pipeline-parallel sibling: the same
microbatch grad accumulation, but *through* the pipe of
:mod:`repro_torch.dist.pipeline` (uneven stage cuts, gpipe or 1f1b
schedule), one process a row or (``model``) one process a stage.  Its
state must be created with ``init_pipeline_state`` (or padded with
``pad_pipeline_state``) so the block list carries the padded per-stage
layout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.dist import tensor as tp
from repro_torch.models import encdec, transformer
from repro_torch.optim import adamw
from repro_torch.tree import leaves, tree_map, unflatten


def cross_entropy(logits, targets, mask=None):
    """f32 token-mean CE.  logits (B, S, V), targets (B, S) int."""
    logp = F.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, targets[..., None].long())[..., 0]
    if mask is None:
        return -ll.mean()
    mask = mask.float()
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _ce_piece(head_fn, h_c, t_c):
    logp = F.log_softmax(head_fn(h_c).float(), dim=-1)  # (B, c, V)
    return logp.gather(-1, t_c[..., None].long())[..., 0].sum()


def chunked_ce(head_fn, hidden, targets, chunk: int = 512):
    """Fused chunked cross-entropy: logits are produced, consumed, and (in
    backward) recomputed one sequence-chunk at a time, so the (B, S,
    vocab) f32 tensor never exists.  The chunk is the largest divisor of S
    that is at most ``chunk``."""
    b, s, _ = hidden.shape
    c = min(chunk, s)
    while s % c:
        c -= 1
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(s // c):
        piece = checkpoint(_ce_piece, head_fn, hidden[:, i * c:(i + 1) * c],
                           targets[:, i * c:(i + 1) * c], use_reentrant=False)
        total = total + piece
    return -total / (b * s)


def make_loss_fn(cfg, aux_weight: float = 0.01, remat: bool = True):
    def loss_fn(params, batch):
        tokens = batch["tokens"]
        if cfg.is_enc_dec:
            hidden, aux = encdec.forward_hidden(params, cfg, batch["frames"],
                                                tokens[:, :-1], remat=remat)
            ce = chunked_ce(lambda h: encdec.head_logits(params, cfg, h), hidden,
                            tokens[:, 1:])
        else:
            hidden, aux = transformer.forward_hidden(params, cfg, tokens[:, :-1],
                                                     batch.get("embeds"), remat=remat)
            # modality prefix tokens (if any) don't predict text targets
            front = hidden.shape[1] - (tokens.shape[1] - 1)
            hidden = hidden[:, front:]
            ce = chunked_ce(lambda h: transformer.head_logits(params, cfg, h), hidden,
                            tokens[:, 1:])
        loss = ce + aux_weight * aux
        return loss, {"ce": ce, "aux": aux}

    return loss_fn


def make_state(params, moments_dtype=torch.float32):
    """A train state around existing ``params``."""
    device = leaves(params)[0].device
    return {"params": params, "opt": adamw.init(params, moments_dtype),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def init_state(cfg, *, generator: torch.Generator, dtype=torch.bfloat16,
               moments_dtype=torch.float32, device="cuda"):
    """A fresh train state: random params from ``generator``."""
    model = encdec if cfg.is_enc_dec else transformer
    params = model.init(cfg, generator=generator, dtype=dtype, device=device)
    return make_state(params, moments_dtype)


def value_and_grad(loss_fn, params, batch):
    """((loss, metrics), grads) of ``loss_fn(params, batch)``; a param the
    loss does not reach gets a zero gradient, as ``jax.grad`` gives."""
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    loss, metrics = loss_fn(unflatten(params, flat), batch)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), unflatten(params, grads)


def _update(opt_cfg, state, loss, metrics, grads, compress, group, shards, model=None,
            model_shards=None):
    """The step's tail after its (process-local) loss and grads: across
    processes the loss, metrics and grads are ``pmean``ed over the data
    group (each FSDP leaf's grad kept as this process's slice of the
    mean), then the compressor runs on the global gradient and AdamW
    updates this process's slices with the global norm, which counts each
    model slice (``model_shards``) once.  With a compressor the grads are
    ``pmean``ed whole, the compressor runs on them and on ``ef`` gathered
    whole over the data group (each leaf split over 'model' stays this
    rank's slice: the compressor reduces across ``model``), and both are
    cut back to this process's slices: ``ef`` lives in the state as this
    process's slices, as the params do.  Returns (new_state, metrics)."""
    norm_fn = adamw.global_norm
    if group is not None or model is not None:
        from repro_torch.dist import collective

        loss, metrics = collective.pmean((loss, metrics), group)
        if compress is not None:
            grads = collective.pmean(grads, group)
            if "ef" in state:
                state = dict(state, ef=collective.gather_tree(state["ef"], shards, group))
            grads, state = compress.apply(grads, state, model=model, model_shards=model_shards)
            grads = collective.slice_tree(grads, shards, group)
            state = dict(state, ef=collective.slice_tree(state["ef"], shards, group))
        else:
            grads = collective.pmean_scatter(grads, shards, group)

        def norm_fn(g):
            return collective.global_norm(g, shards, group, model_shards, model)
    elif compress is not None:
        grads, state = compress.apply(grads, state)

    new_params, opt, opt_metrics = adamw.apply(opt_cfg, state["params"], grads, state["opt"],
                                               norm_fn)
    new_state = dict(state, params=new_params, opt=opt, step=state["step"] + 1)
    return new_state, {"loss": loss, **metrics, **opt_metrics}


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig, *, grad_accum: int = 1,
                    aux_weight: float = 0.01, remat: bool = True, compress=None,
                    group=None, shards=None, model=None, model_shards=None):
    """``compress``: an optional ``optim.compress`` compressor applied to
    the (mean-reduced) grads before the optimizer.

    ``group`` (``dist.collective.data_group``) runs the step as one of the
    mesh's data positions: it takes the GLOBAL batch and computes on its
    rows of each microbatch (``collective.shard_rows``: rows ``[i*mb +
    p*r, i*mb + (p+1)*r)`` of microbatch ``i``), so that each microbatch
    holds the reference's rows; loss, aux and grads are averaged across
    processes before the update.  ``shards`` (``dist.sharding.data_shards``
    of the params' specs) names the FSDP leaves the state holds as this
    process's slices (``fused``): the step gathers them whole, and AdamW
    updates only the slices under the global grad norm.  A MoE config's
    routing runs across the data group.

    ``model`` (``dist.collective.mesh_groups``: one process per mesh
    position, ``group`` then its data group, None for one data position)
    runs the loss tensor and expert parallel over the model group on the
    leaves' 'model' slices (``model_shards``, ``dist.sharding.model_shards``
    of the specs); the FSDP gather over the data group then gives each
    leaf's (whole, model slice) block.

    A microbatch whose rows do not divide the data positions (batch 4
    over 3) is computed whole by every data position, as the reference's
    jit computes the whole batch's mean whatever its data axes: the mean
    of the processes' equal gradients is their value, and MoE layers
    route the whole microbatch in each process."""
    loss_fn = make_loss_fn(cfg, aux_weight, remat)

    def train_step(state, batch):
        split = group is not None and (len(batch["tokens"]) // grad_accum) % group.size == 0
        with tp.parallel(model=model, routing=group if split else None):
            return _step(state, batch, split)

    def _step(state, batch, split):
        params = state["params"]
        if group is not None:
            from repro_torch.dist import collective

            if split:
                batch = collective.shard_rows(batch, grad_accum, group.size, group.rank)
            params = collective.gather_tree(params, shards, group)
        if grad_accum == 1:
            (loss, metrics), grads = value_and_grad(loss_fn, params, batch)
        else:
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            losses, ms = [], []
            for i in range(grad_accum):
                mb = {k: v.reshape(grad_accum, v.shape[0] // grad_accum, *v.shape[1:])[i]
                      for k, v in batch.items()}
                (l, m), g = value_and_grad(loss_fn, params, mb)
                grads = tree_map(lambda a, gg: a + gg.float() / grad_accum, grads, g)
                losses.append(l)
                ms.append(m)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        return _update(opt_cfg, state, loss, metrics, grads, compress, group, shards, model,
                       model_shards)

    return train_step


def init_pipeline_state(cfg, boundaries, *, generator: torch.Generator,
                        dtype=torch.bfloat16, moments_dtype=torch.float32,
                        device="cuda"):
    """Train state whose blocks are padded to the pipeline's uneven-cut
    layout (the optimizer moments are images of the padded params)."""
    from repro_torch.dist.pipeline import pad_pipeline_params

    params = transformer.init(cfg, generator=generator, dtype=dtype, device=device)
    return make_state(pad_pipeline_params(params, cfg, boundaries), moments_dtype)


def unpad_pipeline_state(state, cfg, boundaries):
    """Strip pipeline padding from a live train state: params AND the
    optimizer moments return to the canonical ``num_layers`` block list.
    This is the layout checkpoints store, so a restore can re-pad for ANY
    later boundary vector or stage count."""
    from repro_torch.dist.pipeline import unpad_pipeline_params

    def un(tree):
        return unpad_pipeline_params(tree, cfg, boundaries)

    opt = state["opt"]
    return dict(state, params=un(state["params"]),
                opt=opt._replace(mu=un(opt.mu), nu=un(opt.nu)))


def pad_pipeline_state(state, cfg, boundaries):
    """Pad a canonical train state (params + optimizer moments) into the
    pipeline's per-stage layout for ``boundaries`` — the restore-side twin
    of :func:`unpad_pipeline_state`."""
    from repro_torch.dist.pipeline import pad_pipeline_params

    def pad(tree):
        return pad_pipeline_params(tree, cfg, boundaries)

    opt = state["opt"]
    return dict(state, params=pad(state["params"]),
                opt=opt._replace(mu=pad(opt.mu), nu=pad(opt.nu)))


def repad_pipeline_state(state, cfg, old_boundaries, new_boundaries):
    """Move a LIVE pipeline train state between boundary vectors: unpad
    the old stage layout back to canonical layer order, re-pad for the new
    cuts.  Parameter and moment values are untouched, so training
    continues as if the new cuts had been used all along (the
    straggler-driven re-cut path)."""
    return pad_pipeline_state(
        unpad_pipeline_state(state, cfg, old_boundaries), cfg, new_boundaries)


def make_pipeline_train_step(cfg, opt_cfg: adamw.AdamWConfig, mesh, *,
                             num_microbatches: int = 8, boundaries=None,
                             schedule: str = "1f1b", aux_weight: float = 0.01,
                             remat: bool = True, compress=None, group=None, shards=None,
                             model=None):
    """Pipeline-parallel ``train_step(state, batch) -> (state, metrics)``.

    Microbatch gradient accumulation runs *through* the pipe
    (``repro_torch.dist.pipeline.make_pipeline_loss_and_grad``): layer
    grads come out padded exactly like the params, so the AdamW update
    takes them leaf by leaf.  ``boundaries`` are the planner's uneven
    layer cuts (``Placement.layer_boundaries``); ``schedule`` is 'gpipe'
    or '1f1b' (bitwise-equal results, fewer idle stage-rounds).  Stages
    may sit on distinct cards: the grad norm sums on the first stage's.
    With a ``group`` the mesh's data axis runs across processes: each runs
    its data shard of the global batch through its own row's stages, and
    the loss and grads are averaged across processes before the update
    (``shards`` as in :func:`make_train_step`: the non-stacked leaves that
    ``pipeline`` splits over the data axes).  An MoE config routes as the
    reference's pipe does: each data position its own microbatch rows,
    against a capacity sized from the global batch, the aux loss averaged
    over the data positions.

    With a ``model`` group (one process per mesh position: the process is
    one pipeline stage of its row, ``dist.collective.mesh_groups``; its
    state placed by ``dist.sharding.place``, the stage's layers and every
    leaf off 'model') the pipe runs the stage alone and sums the grads of
    the leaves off 'model' over the stages (``make_pipeline_loss_and_grad``);
    each stage's layer grads stay its own.  The clipping norm sums each
    stage's layers over the model group and counts each leaf off 'model'
    once, and AdamW updates this process's leaves: those off 'model' stay
    equal on every stage.  ``shards`` are then the data shards of the
    stage's specs (``dist.sharding.stage_slice``), each stage averaging
    over its own data group.  No compressor runs in this layout.
    """
    from repro_torch.dist.pipeline import make_pipeline_loss_and_grad

    if model is not None and compress is not None:
        raise NotImplementedError("a gradient compressor under one process per pipeline "
                                  "stage is not ported: run the row layout (one process "
                                  "per data position)")
    loss_grad = make_pipeline_loss_and_grad(
        cfg, mesh, num_microbatches=num_microbatches, boundaries=boundaries,
        schedule=schedule, aux_weight=aux_weight, remat=remat, group=group, model=model)

    def train_step(state, batch):
        params = state["params"]
        if group is not None:
            from repro_torch.dist import collective

            params = collective.gather_tree(params, shards, group)
        (loss, metrics), grads = loss_grad(params, batch)
        own = None
        if model is not None:
            # a stage's layers are its own: summed over the stages once each
            own = {k: tree_map(lambda _: (0, model.size) if k == "blocks" else None, v)
                   for k, v in grads.items()}
        return _update(opt_cfg, state, loss, metrics, grads, compress, group, shards, model,
                       own)

    train_step.loss_and_grad = loss_grad
    return train_step
