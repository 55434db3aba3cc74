"""Prefetching batch loader, threads or worker processes (port of
``xfmamba_tpu/data/loader.py``; the same code, numpy only).

- threads (default): the PNG inflate (zlib), the native unfilter and
  normalisation release the GIL, so a thread pool overlaps decoding with
  the card's work;
- processes (``use_processes=True``): a fork-based pool sidesteps the GIL
  for the numpy glue.  Workers touch numpy and the host library only, never
  CUDA.

Batches are channels-last numpy dicts {"image1", "image2", "label",
"n_valid"}; the epoch driver (`train/driver.py`) moves them to the device.
Training batches drop the remainder; eval batches are zero-padded to the
batch size and carry ``n_valid``, so every batch takes one route through
the model.  At most ``prefetch + num_workers`` batches are in flight.  Generators: a sample's ``seed * 100003 + index`` (the batch's
seed), the epoch's shuffle ``seed + epoch``, a batch's seed ``seed +
1_000_003 * epoch + k``: both pool modes, and the JAX loader, give the
same batches.

``process_slice`` (JAX's, `parallel.distributed.process_batch_slice`):
every process builds the same order of global batches and assembles only
its slice of each, so the rows of W processes are those of one.  A padded
eval batch whose real samples end before a process's slice gives that
process a batch of padding only (``n_valid`` 0), where JAX's loader fails.
"""

from __future__ import annotations

import collections
import itertools
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from xfmamba_tpu_torch.data.device_pipeline import StagingTransform


def staged_or(config: Dict, train_tf, eval_tf):
    """(train, eval) transforms of a dataset's loaders: with the config's
    ``device_preprocess`` both stage uint8 at the image size
    (`data.device_pipeline.StagingTransform`) and the float work runs on the
    card; else the host transforms given."""
    if config.get("device_preprocess"):
        staged = StagingTransform(tuple(config["image_size"]))
        return staged, staged
    return train_tf, eval_tf


class TwoViewSamples:
    """A list of (path1, path2, label) samples + a decode/transform fn."""

    def __init__(self, samples: Sequence[Tuple], load_fn: Callable,
                 transform=None):
        self.samples = list(samples)
        self.load_fn = load_fn
        self.transform = transform

    def __len__(self):
        return len(self.samples)

    def get(self, idx: int, rng: Optional[np.random.Generator] = None):
        img1, img2, label = self.load_fn(self.samples[idx])
        if self.transform is not None:
            img1 = self.transform(img1, rng)
            img2 = self.transform(img2, rng)
        return img1, img2, label


def _assemble_batch(dataset: TwoViewSamples, b: np.ndarray, base_seed: int,
                    target: int, pad_to_batch: bool, shape_from: np.ndarray = None) -> Dict:
    """Decode + transform one batch of sample indices (shared by the
    thread and process pools; per-sample rng keyed by (seed, index) so
    both modes produce bit-identical batches).  An empty ``b`` gives a
    batch of ``target`` zero rows shaped as the sample ``shape_from``."""
    if len(b) == 0:
        like = _assemble_batch(dataset, shape_from, base_seed, target, pad_to_batch)
        return {k: np.zeros_like(like[k]) for k in ("image1", "image2", "label")} | {
            "n_valid": 0}
    n_valid = len(b)
    outs1, outs2, labels = [], [], []
    for i in b:
        rng = np.random.default_rng(base_seed * 100003 + int(i))
        i1, i2, lab = dataset.get(int(i), rng)
        outs1.append(i1)
        outs2.append(i2)
        labels.append(lab)
    img1 = np.stack(outs1)
    img2 = np.stack(outs2)
    label = np.asarray(labels)
    if pad_to_batch and n_valid < target:
        pad = target - n_valid
        img1 = np.concatenate(
            [img1, np.zeros((pad,) + img1.shape[1:], img1.dtype)])
        img2 = np.concatenate(
            [img2, np.zeros((pad,) + img2.shape[1:], img2.dtype)])
        label = np.concatenate(
            [label, np.zeros((pad,) + label.shape[1:], label.dtype)])
    return {"image1": img1, "image2": img2, "label": label,
            "n_valid": n_valid}


# --- process-pool worker state: the dataset is shipped ONCE via the pool
# initializer (fork inherits it for free; spawn pickles it once per
# worker), so per-batch submissions carry only (indices, seed).
_WORKER_DATASET: Optional[TwoViewSamples] = None


def _pool_init(dataset: TwoViewSamples) -> None:
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _pool_make_batch(b: np.ndarray, base_seed: int, target: int,
                     pad_to_batch: bool, shape_from: np.ndarray = None) -> Dict:
    return _assemble_batch(_WORKER_DATASET, b, base_seed, target,
                           pad_to_batch, shape_from)


class TwoViewLoader:
    """Iterable over batches {'image1', 'image2', 'label', 'n_valid'}."""

    def __init__(self, dataset: TwoViewSamples, batch_size: int,
                 shuffle: bool = False, drop_last: bool = False,
                 num_workers: int = 4, seed: int = 0,
                 pad_to_batch: bool = True, prefetch: int = 4,
                 use_processes: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.pad_to_batch = pad_to_batch
        self.prefetch = prefetch
        self.use_processes = use_processes
        self._epoch = 0
        # this process's slice of every global batch (see the module
        # docstring); None: the whole batch
        self.process_slice: Optional[slice] = None

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _global_batches(self) -> List[np.ndarray]:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
        batches = []
        for s in range(0, n, self.batch_size):
            b = idx[s:s + self.batch_size]
            if self.drop_last and len(b) < self.batch_size:
                break
            batches.append(b)
        return batches

    def _target_batch_size(self) -> int:
        if self.process_slice is None:
            return self.batch_size
        return len(range(*self.process_slice.indices(self.batch_size)))

    def _make_batch(self, b: np.ndarray, base_seed: int, shape_from=None) -> Dict:
        return _assemble_batch(self.dataset, b, base_seed, self._target_batch_size(),
                               self.pad_to_batch, shape_from)

    def _make_pool(self):
        if not self.use_processes:
            return ThreadPoolExecutor(self.num_workers)
        # fork: the dataset is inherited copy-on-write and workers never
        # touch the parent's CUDA context (numpy and the host library only).
        # Override with XFMAMBA_POOL_CTX=spawn if the host forbids fork —
        # the dataset (samples + load_fn + transform) is then pickled to
        # each worker once, so all load fns/transforms are plain
        # classes/dataclasses, never closures.
        ctx = multiprocessing.get_context(
            os.environ.get("XFMAMBA_POOL_CTX", "fork"))
        return ProcessPoolExecutor(self.num_workers, mp_context=ctx,
                                   initializer=_pool_init,
                                   initargs=(self.dataset,))

    def __iter__(self) -> Iterator[Dict]:
        self._epoch += 1
        batches = self._global_batches()
        base_seed = self.seed + 1_000_003 * self._epoch
        target = self._target_batch_size()
        # pool creation AND submission happen on the calling thread:
        # ProcessPoolExecutor forks on first submit, and forking from a
        # worker thread is deprecated
        pool = self._make_pool()

        def submit(k, b):
            local = b if self.process_slice is None else b[self.process_slice]
            shape_from = None if len(local) else b[:1]
            if self.use_processes:
                return pool.submit(_pool_make_batch, local, base_seed + k, target,
                                   self.pad_to_batch, shape_from)
            return pool.submit(self._make_batch, local, base_seed + k, shape_from)

        # at most prefetch + num_workers batches in flight: the workers stay
        # busy and hold a few batches ready, and a consumed batch is dropped
        # with its future, so host memory does not grow with the epoch
        todo = iter(enumerate(batches))
        pending = collections.deque(
            submit(k, b) for k, b in itertools.islice(todo, self.prefetch + self.num_workers))
        try:
            while pending:
                batch = pending.popleft().result()
                nxt = next(todo, None)
                if nxt is not None:
                    pending.append(submit(*nxt))
                yield batch
                del batch
        finally:
            # the pool is joined before the epoch ends: a process pool still
            # shutting down while the next epoch forks can leave its lock
            # held in the new workers, which then hang at their exit
            pool.shutdown(wait=True, cancel_futures=True)
