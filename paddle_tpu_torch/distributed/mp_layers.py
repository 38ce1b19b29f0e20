"""Tensor-parallel (Megatron-style) layers (port of the reference
package's ``distributed/mp_layers.py``).

The reference places each layer's weight over the mesh's model-parallel
axis and lets GSPMD insert the collectives. The port places the weight
as a ``DTensor`` (the global view: ``state_dict`` and the optimizers see
its global shape) and runs the forward on this rank's shard with the
Megatron collectives written out (:mod:`~paddle_tpu_torch.distributed
.plan`): a column-parallel product needs none forward, a row-parallel
product ends in an ``all_reduce``, a vocab-parallel embedding sums its
ranks' rows. Outputs keep the global view: a gathered output is a plain
tensor, an output left sharded (``gather_output=False``, the sequence
parallel pair) is a ``DTensor`` of the layout the reference's constraint
names.

Layout: a ``torch.nn.Linear`` weight is ``[out, in]`` where the
reference's is ``[in, out]``, so the shard dims swap: a column-parallel
weight is ``Shard(0)`` here where the reference's is ``Shard(1)``, a
row-parallel weight ``Shard(1)`` where the reference's is ``Shard(0)``.
:func:`~paddle_tpu_torch.models.load_numpy_state` transposes on load,
as it does for every linear weight.

``ParallelCrossEntropy`` merges the ranks' vocab shards as ``lse = log
sum_r exp(lse_r)`` (a max then a sum over the group) and takes the
label's logit from the rank that holds it. Given the lm head's shard
(``weight=``) and the hidden states, each rank runs the loss kernel on
its shard and the ``[N, V]`` logits never exist; given vocab-sharded
logits, each rank reduces its own columns.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from .api import is_dtensor, shard_tensor
from .placement import Replicate, Shard
from .plan import (ParallelPlan, _block, merge_vocab_shards,
                   vocab_parallel_nll)

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelCrossEntropy",
           "ColumnSequenceParallelLinear", "RowSequenceParallelLinear"]


def _mp_axis_index(mesh, axis_name):
    if axis_name not in mesh.dim_names:
        raise ValueError(f"mesh {mesh} has no axis {axis_name!r}")
    return mesh.dim_names.index(axis_name)


def _placements(mesh, mesh_dim, shard_tensor_dim):
    out = [Replicate()] * mesh.ndim
    out[mesh_dim] = Shard(shard_tensor_dim)
    return out


def _sharded_out(y, plan, axis, dim):
    """This rank's block ``y`` as the global ``DTensor`` sharded on
    ``dim`` over ``axis`` (differentiable)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor import Replicate as TR
    from torch.distributed.tensor import Shard as TS
    pl = [TR()] * plan.mesh.ndim
    pl[plan.mesh.dim_names.index(axis)] = TS(dim % y.dim())
    return DTensor.from_local(y, plan.device_mesh, pl, run_check=False)


def _local_block(x, plan, axis, dim):
    """``x``'s block along ``dim`` over ``axis``: a DTensor laid out so
    is taken as it is, any other DTensor is laid out so first, a plain
    tensor is the global value."""
    from torch.distributed.tensor import Replicate as TR
    from torch.distributed.tensor import Shard as TS
    dim = dim % x.dim()
    if is_dtensor(x):
        pl = [TR()] * plan.mesh.ndim
        pl[plan.mesh.dim_names.index(axis)] = TS(dim)
        if tuple(x.placements) != tuple(pl):
            x = x.redistribute(plan.device_mesh, pl)
        return x.to_local()
    return _Split.apply(x, dim, plan.group(axis))


def _replicated(x):
    """A plain tensor of ``x``'s global value (DTensors gathered, with
    their gradient)."""
    return x.full_tensor() if is_dtensor(x) else x


class _Split(torch.autograd.Function):
    """This rank's block along ``dim`` forward; the blocks gathered
    backward."""

    @staticmethod
    def forward(ctx, x, dim, pg):
        ctx.dim, ctx.pg = dim, pg
        return _block(x, dim, pg)

    @staticmethod
    def backward(ctx, g):
        from .plan import _gather_dim
        return _gather_dim(g.contiguous(), ctx.dim, ctx.pg), None, None


class ColumnParallelLinear(nn.Module):
    """``linear.weight [out, in]`` split along ``out`` over ``axis_name``
    (``Shard(0)``; the bias ``Shard(0)`` too). The input is the global
    activation; ``gather_output=True`` returns the whole output on every
    rank, ``False`` a ``DTensor`` sharded on its last dim over the axis,
    for a :class:`RowParallelLinear` to take as it is."""

    def __init__(self, in_features, out_features, mesh, axis_name="mp",
                 weight_attr=None, has_bias=True, gather_output=True,
                 name=None):
        super().__init__()
        self.mesh = mesh
        self.axis_name = axis_name
        self.gather_output = gather_output
        self._plan, self.linear = _sharded_linear(
            in_features, out_features, mesh, axis_name, has_bias, "column",
            gather_output)

    def forward(self, x):
        y = self.linear(_replicated(x))
        if self.gather_output:
            return y
        return _sharded_out(y, self._plan, self.axis_name, -1)


class RowParallelLinear(nn.Module):
    """``linear.weight [out, in]`` split along ``in`` over ``axis_name``
    (``Shard(1)``); the bias replicated. The input is a ``DTensor``
    sharded on its last dim, this rank's block of it
    (``input_is_parallel=True``), or the global activation; the partial
    products are summed by one ``all_reduce``."""

    def __init__(self, in_features, out_features, mesh, axis_name="mp",
                 weight_attr=None, has_bias=True, input_is_parallel=False,
                 name=None):
        super().__init__()
        self.mesh = mesh
        self.axis_name = axis_name
        self.input_is_parallel = input_is_parallel
        self._plan, self.linear = _sharded_linear(
            in_features, out_features, mesh, axis_name, has_bias, "row")

    def _local_input(self, x):
        if is_dtensor(x) or not self.input_is_parallel:
            return _local_block(x, self._plan, self.axis_name, -1)
        return x

    def forward(self, x):
        return self.linear(self._local_input(x))


class VocabParallelEmbedding(nn.Module):
    """``embedding.weight [V, D]`` split along the vocab over
    ``axis_name``: each rank looks up the ids in its rows, zeros the
    rest, and one ``all_reduce`` sums the ranks."""

    def __init__(self, num_embeddings, embedding_dim, mesh, axis_name="mp",
                 weight_attr=None, name=None):
        super().__init__()
        self.axis_name = axis_name
        md = _mp_axis_index(mesh, axis_name)
        self._plan = ParallelPlan(mesh, tp=axis_name)
        weight = nn.Embedding(num_embeddings, embedding_dim).weight
        self.embedding = ShardedEmbedding(
            shard_tensor(weight, mesh, _placements(mesh, md, 0)), self._plan)

    def forward(self, x):
        return self.embedding(_replicated(x))


class _ShardedLogitsNLL(torch.autograd.Function):
    """Per-row ``lse - pick`` of logits split by columns over the group:
    each rank reduces its own block, merged as in the loss kernel's
    vocab-parallel form."""

    @staticmethod
    def forward(ctx, logits, labels, v0, pg):
        x = logits.float()
        v = x.shape[-1]
        lse_r = torch.logsumexp(x, dim=-1)
        inside = (labels >= v0) & (labels < v0 + v)
        lab = torch.where(inside, labels - v0, torch.zeros_like(labels))
        pick_r = torch.where(inside, x.gather(-1, lab[:, None])[:, 0],
                             torch.zeros_like(lse_r))
        lse, pick = merge_vocab_shards(lse_r, pick_r, pg)
        ctx.save_for_backward(x, lab, inside, lse)
        ctx.dtype = logits.dtype
        return lse - pick

    @staticmethod
    def backward(ctx, g):
        x, lab, inside, lse = ctx.saved_tensors
        p = torch.exp(x - lse[:, None])
        hot = torch.zeros_like(p).scatter_(-1, lab[:, None],
                                           inside[:, None].float())
        return ((p - hot) * g[:, None]).to(ctx.dtype), None, None, None


class ParallelCrossEntropy(nn.Module):
    """Per-token cross entropy over a vocab split on ``axis_name``
    (module docstring): ``forward(logits, label)`` with the logits
    sharded on their last dim (a ``DTensor``, or the global logits), or
    ``forward(hidden, label, weight=lm_head_weight)`` with the head
    placed vocab-parallel, through the loss kernel on each rank's shard.
    Rows at ``ignore_index`` give 0. ``mesh`` defaults to the global
    mesh."""

    def __init__(self, mesh=None, axis_name="mp", ignore_index=-100,
                 name=None):
        super().__init__()
        self.mesh = mesh
        self.axis_name = axis_name
        self.ignore_index = ignore_index
        self._plan = None

    def _get_plan(self):
        if self._plan is None:
            from .process_mesh import get_mesh
            mesh = self.mesh if self.mesh is not None else get_mesh()
            if mesh is None:
                raise ValueError("ParallelCrossEntropy needs a mesh: pass "
                                 "mesh= or call set_mesh()")
            self._plan = ParallelPlan(mesh, tp=self.axis_name)
        return self._plan

    def forward(self, input, label, weight=None):
        plan = self._get_plan()
        axis = self.axis_name
        lab = label.reshape(-1).long()
        if lab.numel() != input.numel() // input.shape[-1]:
            lab = label.squeeze(-1).reshape(-1).long()
        if weight is not None:
            w = plan.local(weight) if is_dtensor(weight) else weight
            h2d = _replicated(input).reshape(-1, input.shape[-1])
            nll = vocab_parallel_nll(h2d, w, lab, plan.rank(axis) * w.shape[0],
                                     plan.group(axis))
        else:
            local = _local_block(input, plan, axis, -1)
            local = local.reshape(-1, local.shape[-1])
            nll = _ShardedLogitsNLL.apply(local, lab,
                                          plan.rank(axis) * local.shape[-1],
                                          plan.group(axis))
        valid = lab != self.ignore_index
        nll = torch.where(valid, nll, torch.zeros_like(nll))
        return nll.reshape(label.shape)


def _seq_dim(ndim):
    if ndim == 3:
        return 1
    if ndim == 2:
        return 0
    raise ValueError(
        f"sequence-parallel linear expects 2-D or 3-D activations, got "
        f"rank {ndim}")


class ColumnSequenceParallelLinear(ColumnParallelLinear):
    """Megatron sequence parallelism's column linear: the input arrives
    split on the sequence (a ``DTensor`` ``Shard(1)`` for ``[B, S, H]``,
    ``Shard(0)`` for ``[S, H]``) and is gathered before the product (its
    gradient reduce-scattered back); the output leaves split on its last
    dim, for the paired row layer."""

    def __init__(self, in_features, out_features, mesh, axis_name="mp",
                 weight_attr=None, has_bias=True, gather_output=False,
                 name=None):
        super().__init__(in_features, out_features, mesh, axis_name,
                         weight_attr, has_bias, gather_output, name)

    def forward(self, x):
        plan, axis = self._plan, self.axis_name
        sd = _seq_dim(x.dim())
        if is_dtensor(x):
            x = plan.gather_sum(_local_block(x, plan, axis, sd), axis, sd)
        else:
            x = plan.copy_to(x, axis)
        return _sharded_out(self.linear.product(x), plan, axis, -1)


class RowSequenceParallelLinear(RowParallelLinear):
    """Megatron sequence parallelism's row linear: the input arrives
    split on its last dim; the partial products are summed and split on
    the sequence by one reduce-scatter (the bias added to each rank's
    block), and the output leaves as a ``DTensor`` split on the
    sequence."""

    def __init__(self, in_features, out_features, mesh, axis_name="mp",
                 weight_attr=None, has_bias=True, input_is_parallel=True,
                 name=None):
        super().__init__(in_features, out_features, mesh, axis_name,
                         weight_attr, has_bias, input_is_parallel, name)

    def forward(self, x):
        plan, axis = self._plan, self.axis_name
        y = self.linear.product(self._local_input(x))
        sd = _seq_dim(y.dim())
        y = self.linear.add_bias(plan.reduce_scatter(y, axis, sd))
        return _sharded_out(y, plan, axis, sd)


class ShardedLinear(nn.Module):
    """A linear whose ``weight [out, in]`` (and ``bias``) is placed over a
    mesh, run on its compute view by ``style``: ``"column"`` (split on
    ``out`` over tp with its bias; the input's gradient summed over tp;
    ``gather_output`` gathers the output's blocks, as an lm head's
    logits), ``"row"`` (split on ``in``, the output summed over tp, then
    the replicated bias added). Without a tp axis each is the plain
    product of the (fsdp-gathered) weight. The public tensor-parallel
    linears hold one as ``linear``, and ``shard_llama`` swaps these in
    for a model's ``nn.Linear`` layers; the parameters keep their
    names."""

    def __init__(self, weight, plan, style, bias=None, gather_output=False):
        super().__init__()
        if style not in ("column", "row"):
            raise ValueError(f"unknown style {style!r}")
        self.weight = weight
        self.register_parameter("bias", bias)
        self.plan = plan
        self.style = style
        self.gather_output = gather_output

    def product(self, x):
        """This rank's product of ``x`` with its shard, no communication
        (a column weight's bias added)."""
        w = self.plan.local(self.weight)
        if self.style == "row" or self.bias is None:
            return F.linear(x, w)
        return F.linear(x, w, self.plan.local(self.bias))

    def add_bias(self, y):
        """``y`` plus the row style's replicated bias."""
        if self.bias is None:
            return y
        return y + self.plan.local(self.bias)

    def forward(self, x):
        plan, tp = self.plan, self.plan.tp
        if self.style == "row":
            return self.add_bias(plan.reduce_from(self.product(x), tp))
        y = self.product(plan.copy_to(x, tp))
        return plan.gather_from(y, tp, -1) if self.gather_output else y


def _sharded_linear(in_features, out_features, mesh, axis_name, has_bias,
                    style, gather_output=False):
    """A public tensor-parallel linear's plan and :class:`ShardedLinear`:
    ``nn.Linear``'s initial weight (and bias) placed by ``style``."""
    md = _mp_axis_index(mesh, axis_name)
    plan = ParallelPlan(mesh, tp=axis_name)
    init = nn.Linear(in_features, out_features, bias=has_bias)
    weight = shard_tensor(init.weight, mesh,
                          _placements(mesh, md, 0 if style == "column" else 1))
    bias = None
    if has_bias:
        bias = shard_tensor(init.bias, mesh,
                            _placements(mesh, md, 0) if style == "column"
                            else [Replicate()] * mesh.ndim)
    return plan, ShardedLinear(weight, plan, style, bias, gather_output)


class ShardedEmbedding(nn.Module):
    """An embedding table placed over a mesh (vocab-parallel over tp):
    each rank looks up the ids in its rows, zeros the rest, and one
    ``all_reduce`` sums the ranks (without tp, a plain lookup of the
    compute view)."""

    def __init__(self, weight, plan):
        super().__init__()
        self.weight = weight
        self.plan = plan

    def forward(self, ids):
        plan, tp = self.plan, self.plan.tp
        w = plan.local(self.weight)
        if tp is None:
            return F.embedding(ids, w)
        v = w.shape[0]
        v0 = plan.rank(tp) * v
        inside = (ids >= v0) & (ids < v0 + v)
        rows = F.embedding(
            torch.where(inside, ids - v0, torch.zeros_like(ids)), w)
        rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
        return plan.reduce_from(rows, tp)
