"""Mixture-of-experts (port of the reference package's
``incubate/moe/__init__.py``): the GShard gating, the sort-based
routing, the gates and ``MoELayer``.

``MoELayer`` routes each token to its top-k experts (gelu MLPs with
stacked weights ``[E, ...]``, biases between) with a per-expert capacity;
tokens past an expert's capacity are dropped, as in the reference. Two
dispatch modes compute the same function:

- ``"ragged"`` (the default): :func:`top_k_routing` sorts the token
  choices by expert, one gather lays tokens out expert-contiguous, and
  the two products are :func:`~paddle_tpu_torch.ops.grouped_gemm
  .grouped_gemm` (the hand-written grouped GEMM on the card; its
  backward launches the same kernel for dx), before one gather combines
  back;
- ``"dense"``: the one-hot dispatch and combine masks of
  :func:`top_k_gating` and plain einsums, the formulation both modes are
  held to.

Each token count's forward is built once and kept in a bounded LRU of
``FN_CACHE_SIZE`` entries, each watched by
:func:`~paddle_tpu_torch.observability.compile_watch.watched_jit` under
``moe_layer`` (and ``moe_mlp`` for the Llama MoE FFN), so token counts
that keep changing show in ``paddle_tpu_xla_compile_total`` and the
recompile-storm detector as they do in the reference.

Routing stays on the logits' device: no ``.item()`` and no boolean
indexing. The dropped-token metrics read one count to the host, and only
with metrics on, outside a CUDA-graph capture and outside a compiled
step.

Expert parallelism (``mesh=`` / ``ep_axis=``): the stacked expert
weights and biases are placed ``Shard(0)`` over ``ep_axis`` (rank ``r``
holds experts ``[r E/ep, (r + 1) E/ep)``) and the router is replicated.
Every rank routes every token, as in the reference, so ``l_aux`` and
``dropped`` are the reference's values; each rank runs its experts'
part of either dispatch (in the ragged one, the grouped GEMM kernel over
its experts' row groups) and one ``all_reduce`` over the ep group sums
the ranks' outputs. The reference demotes a sharded expert stack to its
XLA formulation; the port keeps its kernel on each rank's shard.
"""

from __future__ import annotations

import collections
import math

import torch
from torch import nn
from torch.nn import functional as F

from ..observability import compile_watch as _cw
from ..observability import metrics as _om
from ..ops.grouped_gemm import grouped_gemm

__all__ = ["MoELayer", "top_k_gating", "top_k_routing", "NaiveGate",
           "GShardGate", "SwitchGate"]


def _top_k(logits, k):
    """Softmax probabilities and their top ``k`` (values, indices); ties
    among equal probabilities pick the lower expert index first, on any
    device (a stable descending sort, then the first k)."""
    probs = torch.softmax(logits.float(), dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    return probs, topv[:, :k], topi[:, :k]


def _aux_loss(probs, topi, e):
    """The switch / GShard load-balancing loss: E * sum_e(me * ce)."""
    me = probs.mean(dim=0)
    ce = F.one_hot(topi[:, 0], e).float().mean(dim=0)
    return e * (me * ce).sum()


def top_k_gating(logits, k, capacity, normalize=True):
    """Top-k gating with a per-expert capacity, as one-hot masks.

    Returns ``(dispatch [N, E, C] f32 one-hot, combine [N, E, C] f32
    weights, aux)``: a token's j-th choice takes the next free slot of
    its expert (every token's first choice before any second one, token
    order within each) and is dropped when that slot is past
    ``capacity``."""
    n, e = logits.shape
    dev = logits.device
    probs, topv, topi = _top_k(logits, k)
    if normalize:
        topv = topv / (topv.sum(dim=-1, keepdim=True) + 1e-9)
    aux = _aux_loss(probs, topi, e)

    dispatch = torch.zeros((n, e, capacity), dtype=torch.float32,
                           device=dev)
    combine = torch.zeros_like(dispatch)
    counts = torch.zeros((e,), dtype=torch.long, device=dev)  # slots taken
    for j in range(k):
        oh = F.one_hot(topi[:, j], e)                          # [N, E]
        pos = oh.cumsum(dim=0) - 1 + counts[None, :]           # slot index
        counts = counts + oh.sum(dim=0)
        pos_tok = (pos * oh).sum(dim=1)                        # [N]
        keep = (pos_tok < capacity).float()
        slot = F.one_hot(pos_tok.clamp(0, capacity - 1), capacity).float()
        mask = oh.float()[:, :, None] * slot[:, None, :] \
            * keep[:, None, None]
        dispatch = dispatch + mask
        combine = combine + topv[:, j][:, None, None] * mask
    return dispatch, combine, aux


def top_k_routing(logits, k, capacity, normalize=True):
    """Route each of N tokens to its top ``k`` of E experts, laid out in
    expert-contiguous slots of ``capacity`` each.

    Entries are taken k-major (every token's first choice, then every
    second choice, token order within each) and sorted by expert with a
    stable sort, so a full expert drops the same tokens as
    :func:`top_k_gating`. Ties as :func:`_top_k`.

    Returns ``(slot_token [E*capacity] (-1 = empty slot), expert_of [N,
    k], pos_of [N, k], keep [N, k] bool, weights [N, k] f32, aux)``;
    integer outputs are int64."""
    n, e = logits.shape
    dev = logits.device
    probs, topv, topi = _top_k(logits, k)
    if normalize:
        topv = topv / (topv.sum(dim=-1, keepdim=True) + 1e-9)
    aux = _aux_loss(probs, topi, e)

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


def group_sizes(expert_of, keep, e):
    """Real rows of each of ``e`` experts ``[E]`` int32: the kept
    choices of each (a comparison and a sum, on the device)."""
    hit = (expert_of.reshape(-1, 1)
           == torch.arange(e, device=expert_of.device)) \
        & keep.reshape(-1, 1)
    return hit.sum(dim=0, dtype=torch.int32)


def _watched_fn_cache(cache, n_tokens, build, name, limit):
    """Bounded-LRU lookup of a compile-watched per-token-count forward,
    the one mechanism behind ``MoELayer.build_fn`` and
    ``LlamaMoEMLP.build_fn``: each new token count builds its forward
    and wraps it with :func:`~paddle_tpu_torch.observability
    .compile_watch.watched_jit` (its first call counted under ``name``),
    and the oldest entries are evicted past ``limit``."""
    fn = cache.get(n_tokens)
    if fn is None:
        fn = _cw.watched_jit(build(n_tokens), name=name)
        cache[n_tokens] = fn
        while len(cache) > limit:
            cache.popitem(last=False)
    else:
        cache.move_to_end(n_tokens)
    return fn


def host_reads_allowed():
    """A forward may read a count to the host for its metrics: metrics
    on, no CUDA graph being captured, not inside a compiled step."""
    if not _om.enabled():
        return False
    if torch.cuda.is_available() and torch.cuda.is_initialized() \
            and torch.cuda.is_current_stream_capturing():
        return False
    from ..jit import in_compiled_step
    return not in_compiled_step()


class _Gate:
    top_k = 2
    normalize = True

    def __init__(self, top_k=None):
        if top_k is not None:
            self.top_k = top_k


class NaiveGate(_Gate):
    """Top-k softmax, no balancing pressure (reference naive_gate.py)."""
    normalize = True


class GShardGate(_Gate):
    """Top-2 with the load-balancing aux loss (reference gshard_gate.py)."""
    top_k = 2


class SwitchGate(_Gate):
    """Top-1 switch routing (reference switch_gate.py)."""
    top_k = 1
    normalize = False


_GATES = {"naive": NaiveGate, "gshard": GShardGate, "switch": SwitchGate}


def _gelu(x):
    # the reference's gelu is the tanh approximation
    return F.gelu(x, approximate="tanh")


class MoELayer(nn.Module):
    """MoE FFN block (reference ``moe_layer.py:263``; the module
    docstring has the two dispatch modes).

    ``forward(x)`` routes each token of ``x [..., d_model]`` to its top-k
    experts, gelu MLPs ``w1 [E, D, H]`` + ``b1 [E, H]``, ``w2 [E, H, D]`` +
    ``b2 [E, D]``, under a router ``gate_weight [D, E]``, all f32,
    drawn from ``generator`` (or torch's default one) on ``device``
    (default: the card). The load-balancing loss of the last forward is
    ``self.l_aux``: add ``moe.l_aux * coeff`` to the training loss, as the
    reference's examples do. ``mesh=`` (a
    :class:`~paddle_tpu_torch.distributed.ProcessMesh` of the started
    world) places the experts over ``ep_axis`` (module docstring); its
    other axes split the batch."""

    #: bound on the per-token-count forward cache (LRU)
    FN_CACHE_SIZE = 8

    def __init__(self, d_model, d_hidden, num_experts, gate="gshard",
                 top_k=None, capacity_factor=1.25, mesh=None, ep_axis="ep",
                 dispatch_mode="ragged", name=None, device=None,
                 generator=None):
        super().__init__()
        if dispatch_mode not in ("ragged", "dense"):
            raise ValueError("dispatch_mode must be 'ragged' or 'dense'")
        plan = None
        if mesh is not None:
            from ..distributed import ProcessMesh
            from ..distributed.plan import ParallelPlan
            if not isinstance(mesh, ProcessMesh):
                raise TypeError("mesh must be a ProcessMesh")
            plan = ParallelPlan(mesh, ep=ep_axis)
            if num_experts % plan.size(ep_axis):
                raise ValueError(
                    f"{num_experts} experts do not split over "
                    f"{plan.size(ep_axis)} ranks of {ep_axis!r}")
            if device is None:
                device = plan.device_mesh.device_type
        from ..device import resolve_device

        self.dispatch_mode = dispatch_mode
        self.d_model = d_model
        self.d_hidden = d_hidden
        self.num_experts = num_experts
        self.capacity_factor = float(capacity_factor)
        if isinstance(gate, str):
            gate = _GATES[gate](top_k)
        elif isinstance(gate, type):
            gate = gate(top_k)
        elif top_k is not None and top_k != gate.top_k:
            # never mutate a caller-owned gate instance
            fresh = type(gate)(top_k)
            fresh.normalize = gate.normalize
            gate = fresh
        self.gate = gate
        self.mesh = mesh
        self.ep_axis = ep_axis
        self.plan = plan
        dev = resolve_device(device)

        def init(shape, scale):
            t = torch.empty(shape, dtype=torch.float32, device=dev)
            t.normal_(0.0, 1.0, generator=generator)
            return nn.Parameter(t * scale)

        e = num_experts
        self.gate_weight = init((d_model, e), 1.0 / math.sqrt(d_model))
        self.w1 = init((e, d_model, d_hidden), 1.0 / math.sqrt(d_model))
        self.b1 = nn.Parameter(torch.zeros((e, d_hidden), device=dev))
        self.w2 = init((e, d_hidden, d_model), 1.0 / math.sqrt(d_hidden))
        self.b2 = nn.Parameter(torch.zeros((e, d_model), device=dev))
        if plan is not None:
            from ..distributed import Replicate, Shard, shard_tensor
            place = [Replicate()] * mesh.ndim
            self.gate_weight = shard_tensor(self.gate_weight, mesh, place)
            place[mesh.dim_names.index(ep_axis)] = Shard(0)
            for attr in ("w1", "b1", "w2", "b2"):
                setattr(self, attr,
                        shard_tensor(getattr(self, attr), mesh, place))
        self.l_aux = None
        #: the last forward's dropped token choices (a device scalar)
        self.dropped = None
        self._fns: "collections.OrderedDict[int, object]" = \
            collections.OrderedDict()

    def _build_fn(self, n_tokens):
        k = self.gate.top_k
        cap = self.capacity(n_tokens)
        e = self.num_experts
        normalize = self.gate.normalize
        plan, ep = self.plan, self.ep_axis
        # this rank's experts [e0, e0 + el) (all of them unplaced); the
        # input's and the combine weights' gradients sum over ep, and the
        # outputs' terms are summed over ep
        el = e if plan is None else e // plan.size(ep)
        e0 = 0 if plan is None else plan.rank(ep) * el

        def local(*ts):
            return ts if plan is None else tuple(plan.local(t) for t in ts)

        def to_ep(t):
            return t if plan is None else plan.copy_to(t, ep)

        def from_ep(t):
            return t if plan is None else plan.reduce_from(t, ep)

        def expert_ffn(dispatched, w1, b1, w2, b2):
            h = _gelu(torch.einsum("ecd,edh->ech", dispatched, w1)
                      + b1[:, None, :])
            return torch.einsum("ech,ehd->ecd", h, w2) + b2[:, None, :]

        def fn_dense(x2d, wg, w1, b1, w2, b2):
            n = x2d.shape[0]
            wg, w1, b1, w2, b2 = local(wg, w1, b1, w2, b2)
            logits = torch.matmul(x2d.float(), wg)
            dispatch, combine, aux = top_k_gating(logits, k, cap, normalize)
            dropped = torch.round(n * k - dispatch.float().sum()) \
                .to(torch.int32)
            dispatch = dispatch[:, e0:e0 + el].to(x2d.dtype)
            combine = to_ep(combine)[:, e0:e0 + el].to(x2d.dtype)
            dispatched = torch.einsum("nec,nd->ecd", dispatch, to_ep(x2d))
            eo = expert_ffn(dispatched, w1, b1, w2, b2)
            out = from_ep(torch.einsum("nec,ecd->nd", combine, eo))
            return out, aux, dropped

        def fn_ragged(x2d, wg, w1, b1, w2, b2):
            n = x2d.shape[0]
            wg, w1, b1, w2, b2 = local(wg, w1, b1, w2, b2)
            logits = torch.matmul(x2d.float(), wg)
            slot_token, expert_of, pos_of, keep, weights, aux = \
                top_k_routing(logits, k, cap, normalize)
            # one gather lays tokens out expert-contiguous (expert e owns
            # rows [e*cap, e*cap + gs[e])); the grouped GEMM gives zeros
            # past each expert's rows, so the gather needs no mask
            gs = group_sizes(expert_of, keep, e)[e0:e0 + el]
            rows = slot_token[e0 * cap:(e0 + el) * cap]
            gathered = to_ep(x2d)[rows.clamp_min(0)]          # [el*cap, D]
            y1 = grouped_gemm(gathered, w1, gs)
            h = _gelu(y1.reshape(el, cap, -1) + b1[:, None, :]) \
                .reshape(el * cap, -1)
            eo = grouped_gemm(h, w2, gs).reshape(el, cap, -1) \
                + b2[:, None, :]
            # the combine, one gather back: token n reads its k slots
            flat_eo = eo.reshape(el * cap, -1)
            mine = (expert_of >= e0) & (expert_of < e0 + el)
            idx = (expert_of - e0).clamp(0, el - 1) * cap \
                + pos_of.clamp(0, cap - 1)                     # [N, k]
            picked = flat_eo[idx]                              # [N, k, D]
            w = (to_ep(weights) * keep * mine).to(x2d.dtype)
            out = from_ep(torch.einsum("nk,nkd->nd", w, picked))
            dropped = (n * k - keep.sum()).to(torch.int32)
            return out, aux, dropped

        return fn_ragged if self.dispatch_mode == "ragged" else fn_dense

    def build_fn(self, n_tokens):
        """The forward for ``n_tokens`` tokens, ``fn(x2d, gate_weight, w1,
        b1, w2, b2) -> (out, aux, dropped)``, watched under
        ``moe_layer``; the cache keeps the most recent
        :attr:`FN_CACHE_SIZE` token counts (LRU)."""
        return _watched_fn_cache(self._fns, int(n_tokens), self._build_fn,
                                 "moe_layer", self.FN_CACHE_SIZE)

    def forward(self, x):
        shape = x.shape
        n = 1
        for s in shape[:-1]:
            n *= s
        x2d = x.reshape(n, shape[-1])
        out, aux, dropped = self.build_fn(n)(
            x2d, self.gate_weight, self.w1, self.b1, self.w2, self.b2)
        self.l_aux, self.dropped = aux, dropped
        # capacity-overflow observability: token choices dropped past
        # capacity this forward (one host read, only where allowed)
        if host_reads_allowed():
            nd = int(dropped)
            _om.counter("moe_dropped_tokens_total",
                        "token-choice slots dropped past expert "
                        "capacity").inc(nd)
            _om.gauge("moe_drop_fraction",
                      "dropped fraction of token-choice slots in the "
                      "last MoE forward").set(nd / float(n * self.gate.top_k))
        return out.reshape(shape)

    def capacity(self, n_tokens):
        return max(1, int(math.ceil(
            n_tokens * self.capacity_factor * self.gate.top_k
            / self.num_experts)))
