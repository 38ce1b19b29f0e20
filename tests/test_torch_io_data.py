"""The port's ``io`` datasets, samplers, ``default_collate_fn`` and
``DataLoader`` against the reference package's, on the same seeded numpy
data.

Tolerance: exact. Samples, index orders (an int ``generator``, the
global numpy seed, a ``DistributedBatchSampler`` epoch) and batches are
host logic and equal the reference's element for element.
"""

import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import io as rio

from paddle_tpu_torch import io as tio

torch.set_num_threads(1)


def _range_ds(mod, n):
    class RangeDS(mod.Dataset):
        def __len__(self):
            return n

        def __getitem__(self, i):
            return np.float32(i), np.int64(i % 3)
    return RangeDS()


def _as_lists(batches):
    out = []
    for b in batches:
        if isinstance(b, (list, tuple)):
            out.append([_as_lists([x])[0] for x in b])
        elif isinstance(b, dict):
            out.append({k: _as_lists([v])[0] for k, v in b.items()})
        elif hasattr(b, "_data"):
            out.append(np.asarray(b._data).tolist())
        else:
            out.append(np.asarray(b).tolist())
    return out


def test_datasets_match_reference():
    rng = np.random.RandomState(0)
    xs, ys = rng.randn(10, 3).astype(np.float32), np.arange(10)
    rt, tt = rio.TensorDataset([xs, ys]), tio.TensorDataset([xs, ys])
    for i in (0, 4, 9):
        for a, b in zip(rt[i], tt[i]):
            np.testing.assert_array_equal(a, b)
    assert len(tt) == len(rt) == 10
    t = tio.TensorDataset([torch.from_numpy(xs), torch.from_numpy(ys)])
    np.testing.assert_array_equal(t[3][0].numpy(), xs[3])
    with pytest.raises(ValueError):
        tio.TensorDataset([xs, ys[:4]])
    a, b = (_range_ds(rio, 5), _range_ds(rio, 3)), (_range_ds(tio, 5),
                                                  _range_ds(tio, 3))
    rc, tc = rio.ConcatDataset(a), tio.ConcatDataset(b)
    assert len(tc) == len(rc) == 8
    assert [tc[i] for i in range(-8, 8)] == [rc[i] for i in range(-8, 8)]
    rz, tz = rio.ComposeDataset(a[:1] * 2), tio.ComposeDataset(b[:1] * 2)
    assert [tz[i] for i in range(5)] == [rz[i] for i in range(5)]
    rs, ts = rio.Subset(a[0], [4, 0, 2]), tio.Subset(b[0], [4, 0, 2])
    assert [ts[i] for i in range(3)] == [rs[i] for i in range(3)]

    class It(tio.IterableDataset):
        def __iter__(self):
            return iter(range(3))
    assert [x for x in tio.ChainDataset([It(), It()])] == [0, 1, 2] * 2
    with pytest.raises(RuntimeError):
        len(It())


@pytest.mark.parametrize("lengths,gen", [([3, 7], 5), ([0.3, 0.7], 11),
                                         ([0.25, 0.25, 0.5], 2)])
def test_random_split_matches_reference(lengths, gen):
    r = rio.random_split(_range_ds(rio, 10), lengths, generator=gen)
    t = tio.random_split(_range_ds(tio, 10), lengths, generator=gen)
    assert [s.indices for s in t] == [s.indices for s in r]
    with pytest.raises(ValueError):
        tio.random_split(_range_ds(tio, 10), [3, 3])


def test_samplers_match_reference():
    ds_r, ds_t = _range_ds(rio, 11), _range_ds(tio, 11)
    assert list(tio.SequenceSampler(ds_t)) == list(rio.SequenceSampler(ds_r))
    for kw in ({"generator": 7}, {"generator": 3, "replacement": True},
               {"generator": 9, "num_samples": 4},
               {"generator": 9, "replacement": True, "num_samples": 20}):
        r, t = rio.RandomSampler(ds_r, **kw), tio.RandomSampler(ds_t, **kw)
        assert list(t) == list(r) and len(t) == len(r), kw
    with pytest.raises(ValueError):
        tio.RandomSampler(ds_t, num_samples=12)
    # the global numpy stream, as the reference draws them
    w = [0.1, 0.0, 2.0, 1.0, 0.5]
    for rep in (True, False):
        np.random.seed(4)
        want = list(rio.WeightedRandomSampler(w, 4, replacement=rep))
        np.random.seed(4)
        assert list(tio.WeightedRandomSampler(w, 4, replacement=rep)) == want
    np.random.seed(5)
    want = list(rio.SubsetRandomSampler([9, 3, 7, 1]))
    np.random.seed(5)
    assert list(tio.SubsetRandomSampler([9, 3, 7, 1])) == want
    for bs, drop in ((3, False), (3, True), (4, False)):
        r = rio.BatchSampler(ds_r, batch_size=bs, drop_last=drop)
        t = tio.BatchSampler(ds_t, batch_size=bs, drop_last=drop)
        assert list(t) == list(r) and len(t) == len(r)
        r = rio.BatchSampler(sampler=rio.RandomSampler(ds_r, generator=2),
                             batch_size=bs, drop_last=drop)
        t = tio.BatchSampler(sampler=tio.RandomSampler(ds_t, generator=2),
                             batch_size=bs, drop_last=drop)
        assert list(t) == list(r)


@pytest.mark.parametrize("shuffle,drop", [(False, False), (True, False),
                                          (True, True)])
def test_distributed_batch_sampler_matches_reference(shuffle, drop):
    for ranks in (1, 3, 4):
        for rank in range(ranks):
            r = rio.DistributedBatchSampler(
                _range_ds(rio, 10), 2, num_replicas=ranks, rank=rank,
                shuffle=shuffle, drop_last=drop)
            t = tio.DistributedBatchSampler(
                _range_ds(tio, 10), 2, num_replicas=ranks, rank=rank,
                shuffle=shuffle, drop_last=drop)
            for epoch in (0, 3):
                r.set_epoch(epoch)
                t.set_epoch(epoch)
                assert list(t) == list(r) and len(t) == len(r)


def test_distributed_batch_sampler_reads_the_process_env(monkeypatch):
    """Without ``num_replicas`` / ``rank``: the trainer env vars (no
    process group here), one process at rank 0 by default."""
    t = tio.DistributedBatchSampler(_range_ds(tio, 10), 2)
    assert (t.nranks, t.local_rank) == (1, 0)
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "4")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "2")
    t = tio.DistributedBatchSampler(_range_ds(tio, 10), 2)
    assert (t.nranks, t.local_rank) == (4, 2)
    r = rio.DistributedBatchSampler(_range_ds(rio, 10), 2, num_replicas=4,
                                    rank=2)
    assert list(t) == list(r)


def test_random_sampler_without_an_int_generator():
    """Stated difference: with no int ``generator`` the seed comes from
    torch's default generator (``torch.manual_seed`` governs the order) or
    from the ``torch.Generator`` given; the reference takes its own
    global key stream."""
    ds = _range_ds(tio, 16)
    torch.manual_seed(3)
    a = list(tio.RandomSampler(ds))
    torch.manual_seed(3)
    assert list(tio.RandomSampler(ds)) == a
    assert sorted(a) == list(range(16))
    g1, g2 = torch.Generator().manual_seed(8), torch.Generator().manual_seed(8)
    assert list(tio.RandomSampler(ds, generator=g1)) == \
        list(tio.RandomSampler(ds, generator=g2))


def test_collate_matches_reference():
    rng = np.random.RandomState(1)
    samples = [{"a": rng.randn(2).astype(np.float32), "b": (i, 0.5 * i, "s"),
                "c": [np.int64(i), rng.randint(0, 9, (3,))]}
               for i in range(4)]
    got = tio.default_collate_fn(samples)
    want = rio.default_collate_fn(samples)
    assert _as_lists([got]) == _as_lists([want])
    assert got["a"].dtype == want["a"].dtype and got["b"][2] == want["b"][2]
    tens = [torch.full((2, 3), float(i)) for i in range(3)]
    ref = [paddle.to_tensor(np.full((2, 3), float(i), np.float32))
           for i in range(3)]
    np.testing.assert_array_equal(tio.default_collate_fn(tens),
                                  rio.default_collate_fn(ref))
    bf = tio.default_collate_fn([t.to(torch.bfloat16) for t in tens])
    assert bf.dtype == torch.bfloat16 and bf.shape == (3, 2, 3)
    with pytest.raises(TypeError):
        tio.default_collate_fn([object()])


@pytest.mark.parametrize("kw", [dict(batch_size=3),
                                dict(batch_size=4, drop_last=True),
                                dict(batch_size=3, num_workers=2),
                                dict(batch_size=None)])
def test_dataloader_matches_reference(kw):
    r = rio.DataLoader(_range_ds(rio, 10), **kw)
    t = tio.DataLoader(_range_ds(tio, 10), **kw)
    assert len(t) == len(r)
    assert _as_lists(list(t)) == _as_lists(list(r))


def test_dataloader_shuffle_with_a_seeded_sampler_and_workers():
    for workers in (0, 2):
        r = rio.DataLoader(_range_ds(rio, 13), batch_sampler=rio.BatchSampler(
            sampler=rio.RandomSampler(_range_ds(rio, 13), generator=6),
            batch_size=4), num_workers=workers)
        t = tio.DataLoader(_range_ds(tio, 13), batch_sampler=tio.BatchSampler(
            sampler=tio.RandomSampler(_range_ds(tio, 13), generator=6),
            batch_size=4), num_workers=workers)
        assert _as_lists(list(t)) == _as_lists(list(r))
    # shuffle=True without a generator still covers every sample once
    got = [int(x) for b in tio.DataLoader(_range_ds(tio, 13), batch_size=4,
                                          shuffle=True) for x in b[0]]
    assert sorted(got) == list(range(13))


def test_iterable_dataset_and_worker_errors():
    class It(tio.IterableDataset):
        def __iter__(self):
            return iter(np.arange(7, dtype=np.int64))

    class RIt(rio.IterableDataset):
        def __iter__(self):
            return iter(np.arange(7, dtype=np.int64))
    for drop in (False, True):
        t = tio.DataLoader(It(), batch_size=3, drop_last=drop)
        r = rio.DataLoader(RIt(), batch_size=3, drop_last=drop)
        assert _as_lists(list(t)) == _as_lists(list(r))
    with pytest.raises(ValueError):
        tio.DataLoader(It(), shuffle=True)
    with pytest.raises(TypeError):
        len(tio.DataLoader(It(), batch_size=3))

    class Bad(tio.Dataset):
        def __len__(self):
            return 8

        def __getitem__(self, i):
            if i == 5:
                raise KeyError("sample 5")
            return np.float32(i)
    before = threading.active_count()
    with pytest.raises(KeyError, match="sample 5"):
        list(tio.DataLoader(Bad(), batch_size=2, num_workers=2))
    # an abandoned prefetching iterator stops its workers
    it = iter(tio.DataLoader(_range_ds(tio, 40), batch_size=1,
                             num_workers=3))
    next(it)
    it.close()
    assert threading.active_count() <= before + 1


def test_worker_info():
    assert tio.get_worker_info() is None and rio.get_worker_info() is None
    w = tio.WorkerInfo(id=1, num_workers=3)
    assert (w.id, w.num_workers, w.dataset) == (1, 3, None)
