"""The port's token feeds against the reference's: the native feed (the
same ``data_feed.cc``, built into each package's own library) and
``PyTokenFeed`` over one seeded corpus, batches identical over 3 epochs;
the contract (each sample once an epoch, drop-last, ``epochs``, the
shuffle seeded), the factory, and the recipe's ``--data`` path through
the prefetcher."""

import numpy as np
import pytest
import torch

from paddle_tpu import native as jnative
from paddle_tpu.io import token_feed as jfeed

from paddle_tpu_torch import native as tnative
from paddle_tpu_torch.io import DevicePrefetcher, PyTokenFeed, TokenFeed

torch.set_num_threads(1)

SAMPLES, ELEMS, BATCH = 11, 9, 3     # 3 batches an epoch, 2 samples dropped


@pytest.fixture
def corpus(tmp_path):
    path = tmp_path / "corpus.bin"
    data = np.random.RandomState(0).randint(
        0, 1000, (SAMPLES, ELEMS)).astype(np.int32)
    data.tofile(path)
    return str(path), data


def _take(feed, n):
    out = [next(feed) for _ in range(n)]
    feed.close()
    return out


@pytest.mark.parametrize("shuffle,seed", [(True, 0), (True, 5),
                                          (False, 0)])
def test_native_feed_matches_reference(corpus, shuffle, seed):
    path, _ = corpus
    n = 3 * (SAMPLES // BATCH)
    want = _take(jnative.TokenFeed(path, ELEMS, BATCH, shuffle=shuffle,
                                   seed=seed), n)
    got = _take(tnative.TokenFeed(path, ELEMS, BATCH, shuffle=shuffle,
                                  seed=seed), n)
    for a, b in zip(want, got):
        assert b.dtype == np.int32 and np.array_equal(a, b)


@pytest.mark.parametrize("shuffle", [True, False])
def test_py_feed_matches_reference(corpus, shuffle):
    path, _ = corpus
    kw = dict(shuffle=shuffle, seed=3, epochs=3)
    want = list(jfeed.PyTokenFeed(path, ELEMS, BATCH, **kw))
    got = list(PyTokenFeed(path, ELEMS, BATCH, **kw))
    assert len(got) == len(want) == 3 * (SAMPLES // BATCH)
    for a, b in zip(want, got):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("cls", [tnative.TokenFeed, PyTokenFeed])
def test_epoch_contract(corpus, cls):
    """Each full sample at most once an epoch, every epoch the same set
    of samples, the last partial batch dropped, and ``epochs`` ending the
    iteration."""
    path, data = corpus
    feed = cls(path, ELEMS, BATCH, seed=1, epochs=2)
    assert feed.num_samples == SAMPLES
    assert feed.batches_per_epoch == SAMPLES // BATCH
    batches = list(feed)
    feed.close()
    assert len(batches) == 2 * (SAMPLES // BATCH)
    rows = {tuple(r): i for i, r in enumerate(data)}
    per = SAMPLES // BATCH
    for e in range(2):
        seen = [rows[tuple(r)] for b in batches[e * per:(e + 1) * per]
                for r in b]
        assert len(set(seen)) == len(seen) == per * BATCH
    first = [rows[tuple(r)] for b in batches[:per] for r in b]
    second = [rows[tuple(r)] for b in batches[per:] for r in b]
    assert first != second          # a new order every epoch


def test_factory_and_errors(corpus, tmp_path, monkeypatch):
    path, _ = corpus
    feed = TokenFeed(path, ELEMS, BATCH)
    assert isinstance(feed, tnative.TokenFeed) and tnative.available()
    feed.close()
    monkeypatch.setattr(tnative, "available", lambda: False)
    assert isinstance(TokenFeed(path, ELEMS, BATCH), PyTokenFeed)
    small = tmp_path / "small.bin"
    np.zeros(ELEMS, np.int32).tofile(small)
    for cls in (tnative.TokenFeed, PyTokenFeed):
        with pytest.raises(ValueError, match="too small"):
            cls(str(small), ELEMS, BATCH)


def test_prefetched_feed_splits_like_the_recipe(corpus):
    """The recipe's input: the feed's ``[B, S + 1]`` int32 batches through
    the prefetcher as int64 ``(ids, labels)`` shifted by one."""
    from paddle_tpu_torch.examples.llama_pretrain import _split
    path, _ = corpus
    raw = _take(tnative.TokenFeed(path, ELEMS, BATCH, seed=2), 4)
    with DevicePrefetcher(tnative.TokenFeed(path, ELEMS, BATCH, seed=2),
                          transform=_split, device="cpu") as feed:
        for want in raw:
            ids, labels = next(feed)
            assert ids.dtype == labels.dtype == torch.int64
            assert np.array_equal(ids.numpy(), want[:, :-1])
            assert np.array_equal(labels.numpy(), want[:, 1:])
