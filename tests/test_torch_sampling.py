"""The port's sampler against the reference's.

- ``SamplingParams``: the same validation, messages and spec round trip.
- The threefry key ``fold_in(PRNGKey(seed), position)``, its random bits
  and the uniform in ``[tiny, 1)`` are bit for bit ``jax.random``'s at
  Llama-3's vocabulary; the Gumbel noise, which goes through ``log``
  twice, is within ``GUMBEL_REL * max(|g|, 1)`` (2^-13) of it.
- ``sampled_next_tokens`` on the same numpy inputs as the reference's:
  greedy, bias and constraint rows bitwise, top-k 1 and a tiny top-p give
  the argmax, and a sampled row may differ only where the reference's own
  two best perturbed scores lie within the Gumbel tolerance of each other
  (or where the top-p boundary lies within the sums' rounding of a token's
  mass): the test computes those margins and asserts them.
- The engine cases of the reference's ``tests/test_sampling.py`` that need
  neither speculation nor a scan, on the port's engine.
- On a model fitted with ``fit_on_prompts`` (a random-init model's logits
  are near-ties): sampled tokens equal the reference engine's (two-op
  path, ``fused_kv=False``) for the same seeds, greedy and sampled rows
  in one batch. The seeds were fixed before the first run.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.inference import sampling as jsampling
from paddle_tpu.inference.serving import LlamaServingEngine as JaxEngine
from paddle_tpu.inference.serving import Request as JaxRequest
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import tiny_llama_config as jax_tiny
from paddle_tpu.quant import quality

from paddle_tpu_torch.inference import GREEDY, SamplingParams
from paddle_tpu_torch.inference.sampling import (keep_thresholds,
                                                 sampled_next_tokens)
from paddle_tpu_torch.inference.serving import LlamaServingEngine, Request
from paddle_tpu_torch.models import (LlamaForCausalLM, load_numpy_state,
                                     tiny_llama_config)
from paddle_tpu_torch.ops import sampling as S

GEOM = dict(max_batch=4, page_size=8, num_pages=48, chunk_block=8,
            chunk_budget=16)
LLAMA3_V = 128256
SEEDS = (0, 123, 2 ** 31 - 1)


# ---------------------------------------------------------------------------
# SamplingParams
# ---------------------------------------------------------------------------
BAD_PARAMS = [dict(temperature=-0.1), dict(temperature=float("nan")),
              dict(temperature=float("inf")), dict(top_p=0.0),
              dict(top_p=1.5), dict(top_k=-1), dict(seed=2 ** 31),
              dict(seed=-1), dict(logit_bias={3: float("inf")}),
              dict(constraint=42)]


@pytest.mark.parametrize("kw", BAD_PARAMS)
def test_params_validation_as_reference(kw):
    with pytest.raises(ValueError) as want:
        jsampling.SamplingParams(**kw)
    with pytest.raises(ValueError) as got:
        SamplingParams(**kw)
    assert str(got.value) == str(want.value)


def test_params_fields_repr_and_spec_as_reference():
    kw = dict(temperature=0.7, top_p=0.9, top_k=5, seed=11, stop=(3, 4),
              logit_bias={7: -1.5, "8": 2})
    p, q = SamplingParams(**kw), jsampling.SamplingParams(**kw)
    assert repr(p) == repr(q)
    assert p.to_spec() == q.to_spec()
    r = SamplingParams.from_spec(p.to_spec())
    assert (r.temperature, r.top_p, r.top_k, r.seed) == (0.7, 0.9, 5, 11)
    assert r.stop == (3, 4) and r.logit_bias == {7: -1.5, 8: 2.0}
    with pytest.raises(ValueError, match="subprocess-replica"):
        SamplingParams(constraint=lambda a, b: None).to_spec()
    assert SamplingParams.from_spec(None) is None
    assert GREEDY.is_greedy and not SamplingParams(temperature=0.7).is_greedy
    assert repr(GREEDY) == repr(jsampling.GREEDY)


# ---------------------------------------------------------------------------
# threefry, bits, uniforms and Gumbel noise against jax.random
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("pos", [0, 1, 4096, 2 ** 20])
def test_threefry_key_bits_and_uniform_bit_for_bit(seed, pos):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), pos)
    k0, k1 = S.fold_key(torch.tensor([seed]), torch.tensor([pos]))
    assert [int(k0), int(k1)] == np.asarray(key).astype(np.int64).tolist()
    bits, u, g = S.gumbel_noise(torch.tensor([seed]), torch.tensor([pos]),
                                torch.tensor([0]), LLAMA3_V)
    want_bits = np.asarray(jax.random.bits(key, (LLAMA3_V,), jnp.uint32))
    assert np.array_equal(bits[0].numpy(), want_bits.astype(np.int64))
    tiny = np.finfo(np.float32).tiny
    want_u = np.asarray(jax.random.uniform(key, (LLAMA3_V,), jnp.float32,
                                           minval=tiny, maxval=1.0))
    assert np.array_equal(u[0].numpy().view(np.int32),
                          want_u.view(np.int32))
    want_g = np.asarray(jax.random.gumbel(key, (LLAMA3_V,), jnp.float32))
    err = np.abs(g[0].numpy() - want_g) / np.maximum(np.abs(want_g), 1.0)
    assert err.max() <= S.GUMBEL_REL


def test_categorical_counters_span_the_batch():
    """``jax.random.categorical`` over ``[B, V]`` draws one key's noise at
    flat counters ``b * V + j``: the port's bases reproduce it, including
    a base past 2^32 (the counter's high word)."""
    key = jax.random.fold_in(jax.random.key(77), 5)
    b, v = 3, 1000
    want = np.asarray(jax.random.bits(key, (b, v), jnp.uint32))
    seeds, folds = torch.full((b,), 77), torch.full((b,), 5)
    bits, _, _ = S.gumbel_noise(seeds, folds, torch.arange(b) * v, v)
    assert np.array_equal(bits.numpy(), want.astype(np.int64))
    # a high word: element 2^32 + 7 of a flat draw
    k0, k1 = S.fold_key(torch.tensor([77]), torch.tensor([5]))
    hi = S.random_bits(k0, k1, torch.tensor([2 ** 32 + 7]))
    y0, y1 = S.threefry2x32(k0, k1, torch.tensor([1]), torch.tensor([7]))
    assert int(hi) == int(y0 ^ y1)


def test_gumbel_argmax_plain_rule():
    """The CPU wrapper is the plain version: argmax of the perturbed kept
    scores; a row that keeps nothing gives its first index, and a NaN score
    is never kept (its comparison with the threshold is false), as in the
    reference's keep mask."""
    rng = np.random.RandomState(0)
    s = torch.from_numpy(rng.randn(4, 300).astype(np.float32))
    seeds, folds = torch.tensor([1, 2, 3, 4]), torch.tensor([9, 9, 9, 9])
    bases = torch.zeros(4, dtype=torch.int64)
    thr = torch.tensor([float("-inf"), 0.5, 10.0, float("-inf")])
    z = S.perturbed_scores(s, seeds, folds, bases, thr)
    got = S.gumbel_argmax(s, seeds, folds, bases, thr)
    assert torch.equal(got, z.argmax(dim=-1))
    assert float(s[1, got[1]]) >= 0.5
    assert int(got[2]) == 0          # nothing kept: all -inf, first index
    s[3, got[3]] = float("nan")
    again = S.gumbel_argmax(s, seeds, folds, bases, thr)
    assert int(again[3]) != int(got[3])
    assert torch.equal(again, S.perturbed_scores(
        s, seeds, folds, bases, thr).argmax(dim=-1))
    with pytest.raises(ValueError, match=r"\[N\]"):
        S.gumbel_argmax(s, seeds[:3], folds, bases, thr)
    with pytest.raises(ValueError, match="integers"):
        S.gumbel_argmax(s, seeds.float(), folds, bases, thr)


# ---------------------------------------------------------------------------
# sampled_next_tokens against the reference's
# ---------------------------------------------------------------------------
def _ref_scores(logits, temps, top_ps, top_ks, seeds, positions, slot_ids,
                slot_vals, cmodes):
    """The reference's perturbed scores ``z`` and its top-p boundary's
    distance (the cumulative mass before the last kept token, minus
    top_p), from its own formulas in jax."""
    n, v = logits.shape
    l = jnp.asarray(logits)
    rows = jnp.arange(n)
    l = l.at[rows[:, None], jnp.clip(slot_ids, 0, v - 1)].add(slot_vals)
    tok = jnp.arange(v)[None, None, :]
    allowed = jnp.any((slot_ids[:, :, None] == tok)
                      & (slot_ids[:, :, None] >= 0), axis=1)
    l = jnp.where((cmodes[:, None] == 1) & ~allowed, -1e30, l)
    ls = l / jnp.maximum(temps, 1e-6)[:, None]
    sl = jnp.sort(ls, axis=-1)[:, ::-1]
    sp = jax.nn.softmax(sl, axis=-1)
    cum_before = jnp.cumsum(sp, axis=-1) - sp
    kk = jnp.where(top_ks > 0, jnp.minimum(top_ks, v), v)
    kth = jnp.take_along_axis(sl, (kk - 1)[:, None], axis=1)
    n_keep = jnp.maximum(jnp.sum(cum_before < top_ps[:, None], axis=-1), 1)
    pth = jnp.take_along_axis(sl, (n_keep - 1)[:, None], axis=1)
    keep = ls >= jnp.maximum(kth, pth)
    g = jnp.stack([jax.random.gumbel(
        jax.random.fold_in(jax.random.PRNGKey(int(s)), int(p)), (v,),
        jnp.float32) for s, p in zip(seeds, positions)])
    z = np.asarray(jnp.where(keep, ls + g, -jnp.inf))
    # the nearest sorted token to the boundary: cum_before vs top_p
    gap = np.min(np.abs(np.asarray(cum_before) - top_ps[:, None]), axis=-1)
    return z, gap


def _margin_ok(z_row, ref_tok, got_tok):
    """Where the two tokens differ: the reference's own gap between them
    is within the Gumbel tolerance (both g within GUMBEL_REL * max(|g|,
    1), g at most 17 in magnitude, plus the rounding of the sums)."""
    a, b = float(z_row[ref_tok]), float(z_row[got_tok])
    tol = 2 * S.GUMBEL_REL * 17.0 + 4 * np.spacing(np.float32(abs(a)))
    return 0.0 <= a - b <= tol


def _step_args(n, v, rng, **over):
    args = {"temps": np.zeros((n,), np.float32),
            "top_ps": np.ones((n,), np.float32),
            "top_ks": np.zeros((n,), np.int32),
            "seeds": rng.randint(0, 2 ** 31 - 1, n).astype(np.int32),
            "positions": rng.randint(0, 2 ** 20, n).astype(np.int32),
            "slot_ids": np.full((n, 4), -1, np.int32),
            "slot_vals": np.zeros((n, 4), np.float32),
            "cmodes": np.zeros((n,), np.int32)}
    args.update(over)
    return args


def _both(logits, args, any_sampled=True):
    ref = np.asarray(jsampling.sampled_next_tokens(
        jnp.asarray(logits), **{k: jnp.asarray(a) for k, a in args.items()}))
    got = sampled_next_tokens(
        torch.from_numpy(logits),
        **{k: torch.from_numpy(a) for k, a in args.items()},
        any_sampled=any_sampled).numpy()
    return ref, got


@pytest.mark.parametrize("n,v", [(5, 33), (8, 32000), (3, LLAMA3_V)])
def test_greedy_bias_and_constraint_rows_bitwise(n, v):
    rng = np.random.RandomState(v)
    logits = (rng.randn(n, v) * 2).astype(np.float32)
    slot_ids = np.full((n, 4), -1, np.int32)
    slot_vals = np.zeros((n, 4), np.float32)
    cmodes = np.zeros((n,), np.int32)
    slot_ids[1, :2], slot_vals[1, :2] = [3, v - 1], [9.0, 20.0]   # bias
    slot_ids[2, :4] = [1, 2, 7, v + 5]     # allowed (one past the vocab)
    slot_vals[2, 0] = 0.5
    cmodes[2] = 1
    slot_ids[0, :2] = [0, 0]            # a repeated slot adds twice
    slot_vals[0, :2] = [30.0, 1.0]
    args = _step_args(n, v, rng, slot_ids=slot_ids, slot_vals=slot_vals,
                      cmodes=cmodes)
    for any_sampled in (True, False):
        ref, got = _both(logits, args, any_sampled)
        assert np.array_equal(ref, got)
    assert got[0] == 0 and got[1] == v - 1 and got[2] in (1, 2, 7)
    if n > 3:
        assert np.array_equal(got[3:], logits[3:].argmax(-1))
    # bf16 logits: the greedy rows are bitwise the argmax of the bf16 row
    lb = torch.from_numpy(logits).bfloat16()
    plain = _step_args(n, v, rng)
    out = sampled_next_tokens(lb, **{k: torch.from_numpy(a)
                                     for k, a in plain.items()})
    assert torch.equal(out, lb.argmax(dim=-1))


def test_top_k_one_and_tiny_top_p_give_the_argmax():
    rng = np.random.RandomState(1)
    logits = rng.randn(6, 517).astype(np.float32)
    for over in (dict(top_ks=np.ones((6,), np.int32)),
                 dict(top_ps=np.full((6,), 1e-6, np.float32))):
        args = _step_args(6, 517, rng, temps=np.full((6,), 1.3, np.float32),
                          **over)
        ref, got = _both(logits, args)
        assert np.array_equal(ref, logits.argmax(-1))
        assert np.array_equal(got, ref)


@pytest.mark.parametrize("n,v,scale", [(16, 1000, 1.0), (8, 32000, 3.0),
                                       (6, LLAMA3_V, 4.0)])
def test_sampled_rows_match_reference(n, v, scale):
    rng = np.random.RandomState(n * 7 + v)
    logits = (rng.randn(n, v) * scale).astype(np.float32)
    temps = rng.choice([0.0, 0.5, 0.8, 1.0, 1.3], n).astype(np.float32)
    top_ps = rng.choice([1.0, 0.95, 0.9, 0.5], n).astype(np.float32)
    top_ks = rng.choice([0, 0, 1, 5, 50], n).astype(np.int32)
    slot_ids = np.full((n, 4), -1, np.int32)
    slot_vals = np.zeros((n, 4), np.float32)
    cmodes = np.zeros((n,), np.int32)
    slot_ids[0, :3] = [4, 5, 6]
    cmodes[0] = 1
    temps[0] = 1.0
    slot_ids[1, 0], slot_vals[1, 0], temps[1] = 9, 3.0, 0.9
    args = _step_args(n, v, rng, temps=temps, top_ps=top_ps, top_ks=top_ks,
                      slot_ids=slot_ids, slot_vals=slot_vals, cmodes=cmodes)
    ref, got = _both(logits, args)
    assert got[0] in (4, 5, 6)
    z, gap = _ref_scores(logits, **args)
    for i in np.nonzero(ref != got)[0]:
        assert temps[i] > 0, f"greedy row {i} differs"
        assert _margin_ok(z[i], ref[i], got[i]) or gap[i] < 1e-5, (
            f"row {i}: {ref[i]} vs {got[i]}, margin "
            f"{z[i][ref[i]] - z[i][got[i]]}, top-p gap {gap[i]}")
    # the draw is a function of (seed, position): rows reversed give the
    # same tokens reversed
    perm = np.arange(n)[::-1].copy()
    rev = {k: np.ascontiguousarray(a[perm]) for k, a in args.items()}
    _, got_rev = _both(np.ascontiguousarray(logits[perm]), rev)
    assert np.array_equal(got_rev, got[perm])


def test_keep_thresholds_as_reference():
    """The keep threshold of top-k and top-p rows against the reference's
    formulas, away from a top-p boundary."""
    rng = np.random.RandomState(5)
    ls = (rng.randn(6, 400) * 2).astype(np.float32)
    top_ps = np.array([1.0, 0.9, 0.5, 0.99, 1.0, 0.3], np.float32)
    top_ks = np.array([0, 0, 0, 10, 1, 40], np.int32)
    sl = jnp.sort(jnp.asarray(ls), axis=-1)[:, ::-1]
    sp = jax.nn.softmax(sl, axis=-1)
    cum_before = np.asarray(jnp.cumsum(sp, axis=-1) - sp)
    kk = np.where(top_ks > 0, top_ks, 400)
    n_keep = np.maximum((cum_before < top_ps[:, None]).sum(-1), 1)
    want = np.maximum(np.asarray(sl)[np.arange(6), kk - 1],
                      np.asarray(sl)[np.arange(6), n_keep - 1])
    got = keep_thresholds(torch.from_numpy(ls), torch.from_numpy(top_ps),
                          torch.from_numpy(top_ks)).numpy()
    assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLlama(jax_tiny())
    quality.fit_on_prompts(jm, steps=20)
    jm.eval()
    arrays = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(tiny_llama_config(), device="cpu")
    return jm, load_numpy_state(tm, arrays)


def _engine(tm, **kw):
    return LlamaServingEngine(tm, **{**GEOM, **kw})


def _run(engine, prompt, n, sampling=None, stop=()):
    r = Request(prompt, max_new_tokens=n, sampling=sampling, stop=stop)
    engine.add_request(r)
    while not r.done:
        engine.step()
    return r


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 128, (n,)).tolist() for n in lens]


def test_greedy_bitwise_vs_sampling_off(models):
    _, tm = models
    prompts = _prompts(0, (5, 9, 3))
    want = _engine(tm, sampling=False).generate(prompts, max_new_tokens=6)
    assert _engine(tm, sampling=True).generate(prompts, 6) == want


def test_greedy_row_unchanged_next_to_sampled_row(models):
    _, tm = models
    pg, ps = _prompts(5, (6, 4))
    want = _engine(tm, sampling=False).generate([pg], max_new_tokens=8)[0]
    e = _engine(tm)
    rg = Request(pg, max_new_tokens=8)
    rs = Request(ps, max_new_tokens=8,
                 sampling=SamplingParams(temperature=1.2, seed=7))
    e.add_request(rg)
    e.add_request(rs)
    while not (rg.done and rs.done):
        e.step()
    assert rg.output_ids == want


def test_same_seed_same_sequence(models):
    _, tm = models
    p, = _prompts(6, (5,))
    e = _engine(tm)
    sp = SamplingParams(temperature=1.0, seed=42)
    assert _run(e, p, 8, sp).output_ids == _run(e, p, 8, sp).output_ids


def test_auto_seed_recorded_and_reproducible(models):
    _, tm = models
    p, = _prompts(7, (5,))
    e = _engine(tm)
    r = _run(e, p, 8, SamplingParams(temperature=1.0))
    assert r._seed is not None and 0 <= r._seed < 2 ** 31
    replay = _run(e, p, 8, SamplingParams(temperature=1.0, seed=r._seed))
    assert replay.output_ids == r.output_ids
    # the auto-seed LCG is the reference's
    e._auto_seed = 1234
    a = _run(e, p, 2, SamplingParams(temperature=1.0))
    assert a._seed == (1234 * 1103515245 + 12345) % 2 ** 31


def test_sampled_engine_rejects_when_disabled(models):
    _, tm = models
    e = _engine(tm, sampling=False)
    with pytest.raises(ValueError, match="sampling=False"):
        _run(e, [1, 2, 3], 4, SamplingParams(temperature=1.0, seed=1))


def test_request_rejects_non_params():
    with pytest.raises(ValueError, match="SamplingParams"):
        Request([1, 2], sampling={"temperature": 1.0})


def test_stop_tokens(models):
    _, tm = models
    p, = _prompts(11, (6,))
    ref = _engine(tm).generate([p], max_new_tokens=8)[0]
    e = _engine(tm)
    r = _run(e, p, 8, stop=[ref[3]])
    assert r.status == "completed"
    assert r.output_ids == ref[:ref.index(ref[3])]
    assert not e._live and e.alloc.free_pages == e.alloc.num_pages
    r = _run(e, p, 8, SamplingParams(stop=(ref[2],)))
    assert r.output_ids == ref[:ref.index(ref[2])]


def test_logit_bias_forces_token(models):
    _, tm = models
    p, = _prompts(14, (5,))
    e = _engine(tm)
    for sp in (SamplingParams(logit_bias={3: 1e9}),
               SamplingParams(temperature=1.0, seed=4, logit_bias={3: 1e9})):
        assert _run(e, p, 4, sp).output_ids == [3, 3, 3, 3]
    # an engine with sampling off ignores the bias of a greedy request,
    # as the reference's does
    want = _engine(tm).generate([p], max_new_tokens=4)[0]
    off = _engine(tm, sampling=False)
    assert _run(off, p, 4, SamplingParams(logit_bias={3: 1e9})).output_ids \
        == want


def test_constraint_hook_restricts_outputs(models):
    _, tm = models
    p, = _prompts(15, (5,))
    allowed = [2, 5, 8]
    calls = []

    def constraint(prompt_ids, output_ids):
        calls.append(len(output_ids))
        return allowed

    e = _engine(tm)
    r = _run(e, p, 5, SamplingParams(temperature=1.0, seed=3,
                                     constraint=constraint))
    assert r.status == "completed"
    assert all(t in allowed for t in r.output_ids)
    # once per dispatch: the prompt's one chunk, then 4 decode steps
    assert calls == [0, 1, 2, 3, 4]


@pytest.mark.parametrize("hook", [
    lambda p, o: 1 / 0, lambda p, o: [], lambda p, o: None])
def test_constraint_hook_degrades_to_unconstrained(models, hook):
    _, tm = models
    p, = _prompts(16, (5,))
    want = _engine(tm).generate([p], max_new_tokens=4)[0]
    r = _run(_engine(tm), p, 4, SamplingParams(constraint=hook))
    assert r.status == "completed"
    assert r.output_ids == want   # greedy, unconstrained


def test_constraint_wider_than_slots_is_cut(models):
    _, tm = models
    p, = _prompts(17, (5,))
    e = _engine(tm, sample_slots=2)
    r = _run(e, p, 4, SamplingParams(temperature=1.0, seed=8,
                                     constraint=lambda a, b: [9, 11, 13]))
    assert all(t in (9, 11) for t in r.output_ids)


def test_bias_wider_than_slots_rejected(models):
    _, tm = models
    e = _engine(tm, sample_slots=2)
    with pytest.raises(ValueError, match="sample_slots"):
        _run(e, [1, 2, 3], 2,
             SamplingParams(logit_bias={1: 1., 2: 1., 3: 1.}))


def test_all_greedy_dispatch_skips_the_sampler(models, monkeypatch):
    """A dispatch of greedy rows without bias runs the argmax alone; a
    bias-only dispatch sorts nothing; a sampled one launches one Gumbel
    pass."""
    _, tm = models
    from paddle_tpu_torch.inference import serving as SV
    calls = []
    real = SV.sampled_next_tokens

    def spy(*a, **k):
        calls.append(k["any_sampled"])
        return real(*a, **k)

    monkeypatch.setattr(SV, "sampled_next_tokens", spy)
    p, = _prompts(18, (5,))
    e = _engine(tm)
    _run(e, p, 3)
    assert calls == []
    _run(e, p, 3, SamplingParams(logit_bias={4: 1.0}))
    assert calls == [False] * 3
    _run(e, p, 3, SamplingParams(temperature=0.7, seed=1))
    assert calls == [False] * 3 + [True] * 3


SAMPLED = [(0.0, 1.0, 0), (1.0, 1.0, 0), (0.8, 0.9, 0), (1.0, 1.0, 50),
           (1.3, 0.8, 0), (0.7, 1.0, 5)]


def test_sampled_tokens_match_reference_engine(models):
    """Greedy and sampled rows in one batch, prompts longer than one
    chunk budget, seeds fixed: the port's tokens are the reference
    engine's."""
    jm, tm = models
    prompts = _prompts(31, (13, 5, 22, 9, 30, 7))
    seeds = (None, 11, 12, 13, 2 ** 31 - 1, 0)

    def reqs(req_cls, params_cls):
        return [req_cls(p, 10, sampling=params_cls(
            temperature=t, top_p=pp, top_k=k, seed=s))
            for p, (t, pp, k), s in zip(prompts, SAMPLED, seeds)]

    geom = {**GEOM, "max_batch": 6, "num_pages": 64}

    def serve(engine, rs):
        for r in rs:
            engine.add_request(r)
        while not all(r.done for r in rs):
            engine.step()
        return [r.output_ids for r in rs]

    je = JaxEngine(jm, fused_kv=False, prefix_cache=False, **geom)
    want = serve(je, reqs(JaxRequest, jsampling.SamplingParams))
    je.close()
    got = serve(LlamaServingEngine(tm, **geom), reqs(Request, SamplingParams))
    assert got == want
    assert len(set(map(tuple, want))) == len(want)
