"""Placements: ``Shard`` / ``Replicate`` / ``Partial`` (port of the
reference package's ``distributed/placement.py``).

A placements list has one entry per MESH axis: how the tensor relates to
that axis. Each converts to torch's placement of the same meaning
(:meth:`Placement.to_torch`) and back (:func:`from_torch`), so a tensor
placed through this API is a ``DTensor`` with the same layout.
"""

from __future__ import annotations

__all__ = ["Placement", "Shard", "Replicate", "Partial"]


class Placement:
    def is_shard(self, dim=None):
        return False

    def is_replicated(self):
        return False

    def is_partial(self):
        return False

    def to_torch(self):
        raise NotImplementedError


class Shard(Placement):
    """Tensor dimension ``dim`` is split across this mesh axis."""

    def __init__(self, dim):
        self.dim = int(dim)

    def get_dim(self):
        return self.dim

    def is_shard(self, dim=None):
        return dim is None or dim == self.dim

    def to_torch(self):
        from torch.distributed.tensor import Shard as TShard
        return TShard(self.dim)

    def __eq__(self, other):
        return isinstance(other, Shard) and other.dim == self.dim

    def __hash__(self):
        return hash(("shard", self.dim))

    def __repr__(self):
        return f"Shard(dim={self.dim})"


class Replicate(Placement):
    def is_replicated(self):
        return True

    def to_torch(self):
        from torch.distributed.tensor import Replicate as TReplicate
        return TReplicate()

    def __eq__(self, other):
        return isinstance(other, Replicate)

    def __hash__(self):
        return hash("replicate")

    def __repr__(self):
        return "Replicate()"


class Partial(Placement):
    """A reduction pending along this mesh axis: each rank holds a term
    (``reduce_type`` "sum", "avg", "max" or "min"); resharding to
    ``Replicate`` runs it."""

    def __init__(self, reduce_type="sum"):
        self.reduce_type = reduce_type

    def is_partial(self):
        return True

    def to_torch(self):
        from torch.distributed.tensor import Partial as TPartial
        return TPartial(self.reduce_type)

    def __eq__(self, other):
        return isinstance(other, Partial) and \
            other.reduce_type == self.reduce_type

    def __hash__(self):
        return hash(("partial", self.reduce_type))

    def __repr__(self):
        return f"Partial(reduce_type={self.reduce_type})"


def to_torch(placements):
    """One torch placement per entry of ``placements``."""
    return tuple(p.to_torch() for p in placements)


def from_torch(placements):
    """The port's placements of torch's ``placements``."""
    out = []
    for p in placements:
        if p.is_shard():
            out.append(Shard(p.dim))
        elif p.is_partial():
            out.append(Partial(getattr(p, "reduce_op", "sum")))
        else:
            out.append(Replicate())
    return out
