"""Sort-based mixture-of-experts routing (port of ``top_k_routing`` in
``paddle_tpu/incubate/moe/__init__.py``; the dense gates and
``MoELayer`` are not ported yet).

Everything stays on the logits' device: no ``.item()`` and no boolean
indexing, so the routing of a dispatch on the card never waits for the
host.
"""

from __future__ import annotations

import torch

__all__ = ["top_k_routing"]


def top_k_routing(logits, k, capacity, normalize=True):
    """Route each of N tokens to its top ``k`` of E experts, laid out in
    expert-contiguous slots of ``capacity`` each.

    Entries are taken k-major (every token's first choice, then every
    second choice, token order within each) and sorted by expert with a
    stable sort, so a full expert drops the same tokens as the
    reference. Ties among equal probabilities pick the lower expert
    index first, on any device (a stable descending sort, then the
    first k).

    Returns ``(slot_token [E*capacity] (-1 = empty slot), expert_of [N,
    k], pos_of [N, k], keep [N, k] bool, weights [N, k] f32, aux)``;
    integer outputs are int64."""
    n, e = logits.shape
    dev = logits.device
    probs = torch.softmax(logits.float(), dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :k], topi[:, :k]
    if normalize:
        topv = topv / (topv.sum(dim=-1, keepdim=True) + 1e-9)
    me = probs.mean(dim=0)
    ce = torch.nn.functional.one_hot(topi[:, 0], e).float().mean(dim=0)
    aux = e * (me * ce).sum()

    nk = n * k
    flat_expert = topi.t().reshape(-1)                      # k-major [nk]
    flat_token = torch.arange(n, device=dev).repeat(k)
    order = torch.sort(flat_expert, stable=True).indices
    se, st = flat_expert[order], flat_token[order]
    # position within each expert's contiguous group
    group_start = torch.searchsorted(se, torch.arange(e, device=dev))
    pos_sorted = torch.arange(nk, device=dev) - group_start[se]
    keep_sorted = pos_sorted < capacity
    buf_idx = se * capacity + pos_sorted.clamp(0, capacity - 1)
    # dropped entries land in one extra slot past the end, cut off after
    buf_idx = torch.where(keep_sorted, buf_idx,
                          torch.full_like(buf_idx, e * capacity))
    slot_token = torch.full((e * capacity + 1,), -1, dtype=torch.long,
                            device=dev).scatter_(0, buf_idx, st)[:-1]
    pos_flat = torch.empty_like(pos_sorted)
    pos_flat[order] = pos_sorted
    keep_flat = torch.empty_like(keep_sorted)
    keep_flat[order] = keep_sorted
    pos_of = pos_flat.reshape(k, n).t()
    keep = keep_flat.reshape(k, n).t()
    return slot_token, topi, pos_of, keep, topv, aux
