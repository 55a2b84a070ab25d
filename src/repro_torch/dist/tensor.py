"""Tensor and expert parallelism over the mesh's 'model' axis: the
collectives that XLA derives from the reference's ``param_specs`` and
``hint`` calls (GSPMD), written by hand for eager PyTorch.

The model code reads an *ambient* model group, as the reference's
``hint`` reads the active mesh: :func:`parallel` sets it (the train step
and ``launch.serve.run_static`` do, one process per mesh position) and
:func:`model_group` returns it.  Without a group every function below
returns its input, so a path that sets none runs exactly as before.

Four ``torch.autograd.Function``s (Megatron's f and g, and two gathers):

  copy     identity forward, ``all_reduce`` backward: the input of a
           column-split layer (each rank's gradient covers only its
           columns' use), and a replicated param used on this rank's
           share of heads (``q_norm``, ``ckv_norm``)
  reduce   ``all_reduce`` forward, identity backward: the output of a
           row-split layer and of the vocab-parallel lookup
  gather   ``all_gather`` forward; backward this rank's slice of the
           gradient when every rank then uses the gathered tensor
           identically (the logits, the experts' outputs), or with
           ``reduce_grad`` the ``reduce_scatter`` of the gradients when the
           ranks use it differently (K / V split inside a head, MLA's
           latent): each rank's gradient then holds only its own reads

The wrong adjoint for a gather gives gradients off by the model size or
missing the other ranks' terms; ``tests/test_torch_tp.py`` holds both.

:func:`sum_across` is the data group's statistic for the MoE router's
load-balancing loss: ``all_reduce`` forward and backward, since every
process's loss reads the sum and the train step averages the processes'
gradients.  :func:`routing_group` is the ambient data group over which
``models.moe`` routes a microbatch's tokens globally (training only).

Which layers split is read from their leaves' widths against the
config's (``split``), never from the strategy's name: a leaf that
``fix_spec`` leaves whole computes whole.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.dist import collective

_MODEL = None
_ROUTING = None


@contextlib.contextmanager
def parallel(model=None, routing=None):
    """Run the block with ``model`` (a ``collective.ModelGroup``) as the
    ambient model group and ``routing`` (a ``collective.DataGroup``) as
    the group a microbatch's MoE tokens are routed across.  The groups are
    module state, not context variables: autograd runs a CUDA backward,
    and the recompute inside it, on a thread of its own."""
    global _MODEL, _ROUTING
    prev = _MODEL, _ROUTING
    _MODEL, _ROUTING = model, routing
    try:
        yield
    finally:
        _MODEL, _ROUTING = prev


def model_group():
    return _MODEL


def routing_group():
    return _ROUTING


def model_rank() -> int:
    return 0 if _MODEL is None else _MODEL.rank


def split(width: int, whole: int) -> bool:
    """True when a leaf dim of ``width`` is this rank's slice of ``whole``
    (tensor or expert parallelism); a slice with no ambient model group
    raises, as it cannot compute alone."""
    if width == whole:
        return False
    if _MODEL is None or width * _MODEL.size != whole:
        raise ValueError(f"a leaf dim of {width} where the config gives {whole}, under "
                         f"the model group {_MODEL}")
    return True


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    return collective.all_reduce_sum([x.contiguous()], group)[0]


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, reduce_grad):
        ctx.dim, ctx.group, ctx.reduce_grad, ctx.width = dim, group, reduce_grad, x.shape[dim]
        return collective.all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce_grad:
            return collective.reduce_scatter_dim(g, ctx.dim, ctx.group), None, None, None
        part = g.narrow(ctx.dim, ctx.group.rank * ctx.width, ctx.width).contiguous()
        return part, None, None, None


class _SumAcross(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def copy(x: torch.Tensor) -> torch.Tensor:
    """Identity forward, gradients summed over the model group."""
    return x if _MODEL is None else _Copy.apply(x, _MODEL)


def copy_tree(p: dict) -> dict:
    """:func:`copy` of every tensor of a param dict (a replicated leaf used
    on this rank's share of the work)."""
    return {k: copy(v) for k, v in p.items()}


def reduce(x: torch.Tensor) -> torch.Tensor:
    """The sum over the model group forward, identity backward."""
    return x if _MODEL is None else _Reduce.apply(x, _MODEL)


def gather(x: torch.Tensor, dim: int, *, reduce_grad: bool = False) -> torch.Tensor:
    """Every model rank's ``x`` concatenated along ``dim``.  Backward takes
    this rank's slice of the gradient, or with ``reduce_grad`` (the ranks
    read the result differently) this rank's slice of the gradients'
    sum."""
    if _MODEL is None:
        return x
    return _Gather.apply(x, dim % x.dim(), _MODEL, reduce_grad)


def sum_across(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (a data group), gradients summed too."""
    return x if group is None else _SumAcross.apply(x, group)
