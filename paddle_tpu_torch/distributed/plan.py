"""How a layer with placed weights runs its forward: on local shards,
with the Megatron communication written out.

The port's kernels are custom ops that torch's ``DTensor`` has no
sharding rule for, so a placed model never hands them a ``DTensor``: its
layers take local views of their weights (:meth:`ParallelPlan.local`)
and put each collective where Megatron-LM puts it:

- a column-parallel product needs no communication forward; its input's
  gradient is a sum over the tp group (:meth:`ParallelPlan.copy_to`);
- a row-parallel product ends in an ``all_reduce`` over the tp group
  (:meth:`ParallelPlan.reduce_from`);
- a weight sharded on a batch axis (fsdp, ZeRO-3) is gathered before use
  and its gradient reduce-scattered back to the shard;
- a weight replicated on a batch axis (dp) gets its gradient averaged
  over that axis once, in the backward of its local view.

Each rank's loss is its term of the global batch's mean
(:meth:`ParallelPlan.loss`), so the averages make each gradient the
global batch's. The gradient of a placed
parameter comes back as a ``DTensor`` of the parameter's own placements,
reduced exactly once.

The mesh's axes play one of two roles. The model axes (``tp``, ``ep``)
split the work of one batch slice; every other axis (dp, fsdp) splits
the batch. Collectives run through ``torch.distributed`` on the axis's
process group whenever a process group exists, a group of one rank
included, so a world of one runs the same NCCL calls as a bigger one.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["ParallelPlan", "merge_vocab_shards", "vocab_parallel_nll"]


def _gather_dim(t, dim, pg):
    """``t``'s blocks of the group concatenated along ``dim``."""
    n = dist.get_world_size(pg)
    t = t.contiguous()
    out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    if dim == 0:
        dist.all_gather_into_tensor(out, t, group=pg)
        return out
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, src, group=pg)
    return out.movedim(0, dim)


def _reduce_scatter_dim(t, dim, pg):
    """This rank's block along ``dim`` of the group's sum of ``t``."""
    n = dist.get_world_size(pg)
    if t.shape[dim] % n:
        raise ValueError(f"dimension {dim} of size {t.shape[dim]} does not "
                         f"split evenly over {n} ranks")
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=t.dtype, device=t.device)
    dist.reduce_scatter_tensor(out, src, group=pg)
    return out.movedim(0, dim)


def _block(t, dim, pg):
    """This rank's block of ``t`` along ``dim``."""
    n, r = dist.get_world_size(pg), dist.get_rank(pg)
    if t.shape[dim] % n:
        raise ValueError(f"dimension {dim} of size {t.shape[dim]} does not "
                         f"split evenly over {n} ranks")
    return t.chunk(n, dim)[r].contiguous()


def _all_reduce(t, pg):
    out = t.contiguous().clone()
    dist.all_reduce(out, group=pg)
    return out


class _CopyTo(torch.autograd.Function):
    """Identity forward; the gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.pg), None


class _ReduceFrom(torch.autograd.Function):
    """A sum over the group forward; identity backward."""

    @staticmethod
    def forward(ctx, x, pg):
        return _all_reduce(x, pg)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    """The group's blocks gathered along ``dim`` forward (what follows
    runs the same on every rank); this rank's block of the gradient."""

    @staticmethod
    def forward(ctx, x, dim, pg):
        ctx.dim, ctx.pg = dim, pg
        return _gather_dim(x, dim, pg)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.dim, ctx.pg), None, None


class _GatherSum(torch.autograd.Function):
    """Gathered along ``dim`` forward; backward, the sum of the ranks'
    gradients, scattered back to the blocks (the sequence-parallel
    all-gather)."""

    @staticmethod
    def forward(ctx, x, dim, pg):
        ctx.dim, ctx.pg = dim, pg
        return _gather_dim(x, dim, pg)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_dim(g, ctx.dim, ctx.pg), None, None


class _ReduceScatter(torch.autograd.Function):
    """The sum over the group, this rank's block along ``dim`` forward;
    the blocks gathered backward."""

    @staticmethod
    def forward(ctx, x, dim, pg):
        ctx.dim, ctx.pg = dim, pg
        return _reduce_scatter_dim(x, dim, pg)

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, ctx.dim, ctx.pg), None, None


class _LocalParam(torch.autograd.Function):
    """A placed parameter's compute view: its local shard, gathered on
    the batch axes it is sharded on. Backward: the local gradient summed
    over every batch axis (reduce-scattered where the parameter is
    sharded) and divided by their ranks, as a ``DTensor`` of the
    parameter's placements."""

    @staticmethod
    def forward(ctx, p, plan):
        local = p.to_local()
        gathered = []
        for mesh_dim, pl in enumerate(p.placements):
            axis = plan.mesh.dim_names[mesh_dim]
            if pl.is_shard() and axis in plan.batch_axes:
                local = _gather_dim(local, pl.dim, plan.group(axis))
                gathered.append((axis, pl.dim))
        ctx.plan, ctx.gathered = plan, gathered
        ctx.spec = (p.device_mesh, p.placements, p.shape, p.stride())
        return local if gathered else local.view_as(local)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor
        plan = ctx.plan
        g = g.contiguous()
        sharded = dict(ctx.gathered)
        ranks = 1
        for axis in plan.batch_axes:
            pg = plan.group(axis)
            ranks *= dist.get_world_size(pg)
            if axis in sharded:
                g = _reduce_scatter_dim(g, sharded[axis], pg)
            else:
                g = _all_reduce(g, pg)
        if ranks > 1:
            g = g / ranks
        mesh, placements, shape, stride = ctx.spec
        return DTensor.from_local(g, mesh, placements, run_check=False,
                                  shape=shape, stride=stride), None


def merge_vocab_shards(lse_r, pick_r, pg):
    """Each row's ``(lse, pick)`` over the vocab split on ``pg``, from
    the ranks' own ``lse_r`` and ``pick_r`` (``pick_r`` 0 where the label
    lies in another rank's shard): ``lse = m + log sum_r exp(lse_r - m)``
    with ``m`` the ranks' max, and ``pick`` the sum of the picks."""
    m = lse_r.clone()
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=pg)
    terms = torch.stack([torch.exp(lse_r - m), pick_r])
    dist.all_reduce(terms, group=pg)
    return m + torch.log(terms[0]), terms[1]


class _VocabParallelNLL(torch.autograd.Function):
    """Per-row ``lse - pick`` of ``h @ w_r^T`` with the vocab split over
    the group: each rank runs the loss kernel (#5) on its own vocab shard
    ``w_r`` (rows ``[v0, v0 + V_r)``), and the ranks' results merge as
    ``lse = m + log sum_r exp(lse_r - m)`` with ``m`` the ranks' max, and
    ``pick`` the sum of the ranks' picks (only the rank that holds a
    row's label has it). The backward is the kernel's plain backward on
    the shard from the merged ``lse``: ``d_weight`` is the shard's own,
    ``d_hidden`` this shard's term of a sum over the group."""

    @staticmethod
    def forward(ctx, h2d, w, labels, v0, pg, chunk):
        from ..ops import fused_linear_cross_entropy as FC
        v = w.shape[0]
        inside = (labels >= v0) & (labels < v0 + v)
        lab = torch.where(inside, labels - v0, torch.full_like(labels, -1))
        lse, pick = merge_vocab_shards(*FC._parts(h2d, w, lab, chunk), pg)
        ctx.save_for_backward(h2d, w, lab, lse)
        ctx.chunk = chunk
        return lse - pick

    @staticmethod
    def backward(ctx, g):
        from ..ops import fused_linear_cross_entropy as FC
        h2d, w, lab, lse = ctx.saved_tensors
        # the shard's labels are -1 or in [0, V_r): -2 marks no row ignored
        dh, dw = FC.linear_cross_entropy_backward(h2d, w, lab, lse, g,
                                                  ctx.chunk, -2)
        return dh, dw, None, None, None, None


def vocab_parallel_nll(h2d, w_shard, labels, v0, pg, chunk=None):
    """The per-row nll of :class:`_VocabParallelNLL` (``h2d`` the same
    on every rank of ``pg``; its gradient is summed over ``pg``)."""
    from ..ops import fused_linear_cross_entropy as FC
    c = max(8, min(int(chunk or FC.default_chunk()), w_shard.shape[0]))
    h2d = _CopyTo.apply(h2d, pg)
    return _VocabParallelNLL.apply(h2d, w_shard, labels.reshape(-1), int(v0),
                                   pg, c)


class ParallelPlan:
    """The roles of a mesh's axes for one model: ``tp`` and ``ep`` split
    the work of a batch slice, ``fsdp`` shards weights and the batch, and
    every other axis (dp) splits the batch. Holds the process groups and
    the region functions the sharded layers call."""

    def __init__(self, mesh, tp=None, ep=None, fsdp=None):
        for axis in (tp, ep, fsdp):
            if axis is not None and axis not in mesh.dim_names:
                raise ValueError(f"mesh {mesh} has no axis {axis!r}")
        self.mesh = mesh
        self.device_mesh = mesh.to_device_mesh()
        self.tp, self.ep, self.fsdp = tp, ep, fsdp
        self.batch_axes = tuple(a for a in mesh.dim_names
                                if a not in (tp, ep))

    def group(self, axis):
        return self.device_mesh.get_group(axis)

    def size(self, axis):
        return 1 if axis is None else self.mesh.get_dim_size(axis)

    def rank(self, axis):
        return 0 if axis is None else self.mesh.axis_rank(axis)

    def batch_slice(self):
        """``(index, count)``: this rank's slice of the global batch, the
        batch axes' coordinates flattened in mesh order."""
        index, count = 0, 1
        for axis in self.batch_axes:
            index = index * self.size(axis) + self.rank(axis)
            count *= self.size(axis)
        return index, count

    def local(self, p):
        """``p``'s compute view (a plain tensor passes)."""
        if type(p).__name__ != "DTensor":
            return p
        return _LocalParam.apply(p, self)

    def copy_to(self, x, axis):
        return x if axis is None else _CopyTo.apply(x, self.group(axis))

    def reduce_from(self, x, axis):
        return x if axis is None else _ReduceFrom.apply(x, self.group(axis))

    def gather_from(self, x, axis, dim=-1):
        if axis is None:
            return x
        return _GatherFrom.apply(x, dim % x.dim(), self.group(axis))

    def gather_sum(self, x, axis, dim):
        return _GatherSum.apply(x, dim % x.dim(), self.group(axis))

    def reduce_scatter(self, x, axis, dim):
        return _ReduceScatter.apply(x, dim % x.dim(), self.group(axis))

    @torch.no_grad()
    def mean_over_batch(self, t):
        """``t`` averaged over the batch axes (no gradient): each rank's
        mean loss -> the global batch's."""
        out = t.detach().clone()
        n = 1
        for axis in self.batch_axes:
            pg = self.group(axis)
            dist.all_reduce(out, group=pg)
            n *= dist.get_world_size(pg)
        return out / n if n > 1 else out

    def loss(self, hidden, weight, labels, ignore_index=-100):
        """This rank's term of the global batch's mean next-token loss of
        ``hidden @ weight^T``, ``weight`` the lm head placed vocab-parallel
        over ``tp``: the loss kernel runs on this rank's vocab shard and
        the shards merge by :func:`vocab_parallel_nll` (without tp, the
        fused loss on the fsdp-gathered head). The term is this rank's
        summed nll times ``B / N``, ``B`` the batch ranks and ``N`` the
        valid rows of all of them (one ``all_reduce`` of a count), so the
        mean over the batch ranks, of the terms and of their gradients
        alike, is the global batch's mean over its valid rows wherever
        ``ignore_index`` rows fall; with equal counts a term is this
        rank's own mean."""
        from ..ops.fused_linear_cross_entropy import fused_linear_cross_entropy
        w = self.local(weight)
        lab = labels.reshape(-1)
        valid = lab != ignore_index
        count = valid.float().sum()
        if self.tp is None:
            total = fused_linear_cross_entropy(
                hidden, w, labels, ignore_index=ignore_index) \
                * count.clamp_min(1.0)
        else:
            h2d = hidden.reshape(-1, hidden.shape[-1])
            v0 = self.rank(self.tp) * w.shape[0]
            nll = vocab_parallel_nll(h2d, w, lab, v0, self.group(self.tp))
            total = torch.where(valid, nll, torch.zeros_like(nll)).sum()
        with torch.no_grad():
            ranks = self.batch_slice()[1]
            everyone = count.clone()
            for axis in self.batch_axes:
                dist.all_reduce(everyone, group=self.group(axis))
            scale = ranks / everyone.clamp_min(1.0)
        return total * scale
