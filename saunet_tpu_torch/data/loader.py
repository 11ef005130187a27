"""Input pipeline: samplers and a prefetching loader (counterpart of
saunet_tpu/data/loader.py, copied; the device hand-off is torch's).

The loader assembles numpy batches on a background thread, overlapping host
work with the device's; `place` (for example `to_device(device)`) runs on
that thread, so the host-to-device copy of batch k+1 overlaps step k. A
failure on the thread is raised in the consumer.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def to_device(device) -> Callable[[Dict[str, np.ndarray]], Dict]:
    """`place` for `ArrayDataLoader`: each array to a tensor on `device`,
    through pinned memory and a non-blocking copy for a CUDA device."""
    device = torch.device(device)

    def place(batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if device.type == "cuda":
                t = t.pin_memory()
            out[k] = t.to(device, non_blocking=True)
        return out

    return place


class Sampler:
    def __iter__(self) -> Iterator[int]:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError


class SequentialSampler(Sampler):
    def __init__(self, n: int):
        self.n = n

    def __iter__(self):
        return iter(range(self.n))

    def __len__(self):
        return self.n


class RandomSampler(Sampler):
    def __init__(self, n: int, rng: Optional[np.random.RandomState] = None):
        self.n = n
        self.rng = rng or np.random.RandomState()

    def __iter__(self):
        return iter(self.rng.permutation(self.n).tolist())

    def __len__(self):
        return self.n


class SubsetRandomSampler(Sampler):
    def __init__(self, indices: Sequence[int],
                 rng: Optional[np.random.RandomState] = None):
        self.indices = np.asarray(indices)
        self.rng = rng or np.random.RandomState()

    def __iter__(self):
        return iter(self.indices[
            self.rng.permutation(len(self.indices))].tolist())

    def __len__(self):
        return len(self.indices)


class WeightedRandomSampler(Sampler):
    def __init__(self, weights: Sequence[float], num_samples: int,
                 replacement: bool = True,
                 rng: Optional[np.random.RandomState] = None):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement
        self.rng = rng or np.random.RandomState()

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = self.rng.choice(len(self.weights), size=self.num_samples,
                              replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class DistributedShardSampler(Sampler):
    """Per-rank shard of a deterministically shuffled index set — the role
    of the reference's (never-used) DistributedSampler: each rank loads only
    its 1/num_shards of the data, reshuffled per epoch by `set_epoch`.
    `num_shards` and `shard_id` default to the process group's size and
    this process's rank (1 and 0 without a group), as the JAX sampler's
    default to `jax.process_count()` and `jax.process_index()`."""

    def __init__(self, n: int, num_shards: Optional[int] = None,
                 shard_id: Optional[int] = None, shuffle: bool = True,
                 seed: int = 0):
        grouped = dist.is_available() and dist.is_initialized()
        self.n = n
        self.num_shards = (num_shards if num_shards is not None
                           else dist.get_world_size() if grouped else 1)
        self.shard_id = (shard_id if shard_id is not None
                         else dist.get_rank() if grouped else 0)
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.shard_len = (n + self.num_shards - 1) // self.num_shards

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self):
        if self.shuffle:
            idx = np.random.RandomState(self.seed + self.epoch).permutation(
                self.n)
        else:
            idx = np.arange(self.n)
        # pad to make evenly divisible (same trick as the reference)
        pad = self.shard_len * self.num_shards - self.n
        idx = np.concatenate([idx, idx[:pad]])
        return iter(idx[self.shard_id::self.num_shards].tolist())

    def __len__(self):
        return self.shard_len


class BatchSampler(Sampler):
    def __init__(self, sampler: Sampler, batch_size: int,
                 drop_last: bool = True):
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for i in self.sampler:
            batch.append(i)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class _PrefetchIterator:
    def __init__(self, make_batch: Callable[[Sequence[int]], Dict],
                 batches: Iterator[Sequence[int]], depth: int,
                 place: Optional[Callable[[Dict], Dict]]):
        self.make_batch = make_batch
        self.batches = batches
        self.place = place
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.error: Optional[BaseException] = None
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _worker(self):
        try:
            for sel in self.batches:
                batch = self.make_batch(sel)
                if self.place is not None:
                    # the copy to the device overlaps the consumer's step
                    batch = self.place(batch)
                self.q.put(batch)
        except BaseException as e:  # propagate to consumer
            self.error = e
        finally:
            self.q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is None:
            if self.error is not None:
                raise self.error
            raise StopIteration
        return item


class ArrayDataLoader:
    """Batches over in-memory arrays with background prefetch and optional
    device placement.

    arrays: dict of numpy arrays with a shared leading dim.
    place:  e.g. `to_device("cuda")`; runs on the prefetch thread.
    """

    def __init__(self, arrays: Dict[str, np.ndarray], batch_size: int,
                 sampler: Optional[Sampler] = None, shuffle: bool = False,
                 drop_last: bool = True, prefetch: int = 2,
                 place: Optional[Callable[[Dict], Dict]] = None,
                 rng: Optional[np.random.RandomState] = None):
        n = len(next(iter(arrays.values())))
        for k, v in arrays.items():
            if len(v) != n:
                raise ValueError(f"array {k!r} length mismatch")
        self.arrays = arrays
        self.n = n
        if sampler is None:
            sampler = RandomSampler(n, rng) if shuffle else SequentialSampler(n)
        self.batch_sampler = BatchSampler(sampler, batch_size, drop_last)
        self.prefetch = prefetch
        self.place = place

    def _make_batch(self, sel: Sequence[int]) -> Dict[str, np.ndarray]:
        idx = np.asarray(sel)
        return {k: v[idx] for k, v in self.arrays.items()}

    def __len__(self):
        return len(self.batch_sampler)

    def __iter__(self):
        return _PrefetchIterator(self._make_batch,
                                 iter(self.batch_sampler),
                                 self.prefetch, self.place)
