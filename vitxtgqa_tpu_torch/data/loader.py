"""Batched, shuffled, epoch-seeded data loading with host prefetch.

The port's copy of vitxtgqa_tpu/data/loader.py (reference:
pythia/datasets/multi_dataset.py:254-293, samplers.py:10-66) for one
process: the loader yields fixed-shape numpy batches on the host, in the
same epoch-seeded order; `prefetch_batches` overlaps their assembly with
the device's compute on a host thread.

Beyond the JAX loader, for an exact resume: ``iter_from`` starts an epoch
at a batch offset, and ``infinite_batches`` tags each batch with its epoch
and its index in the epoch.  With ``num_workers=0`` the samples draw from
the dataset's host generators in order (as in JAX), and each batch carries
their state after its assembly (``host["data_rng"]``); with worker
processes each sample draws from generators seeded by (seed, epoch,
index), so a batch depends on its place alone, whatever the worker count.
"""

from __future__ import annotations

import atexit
import itertools
import threading
import queue as queue_mod
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

from vitxtgqa_tpu_torch.data.dataset import collate


class EpochSampler:
    """Epoch-seeded shuffled (or sequential) indices (the reference
    DistributedSampler's order at world size 1, samplers.py:10-66)."""

    def __init__(self, n: int, shuffle: bool = True, seed: int = 0):
        self.n = n
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def indices(self) -> List[int]:
        if self.shuffle:
            return np.random.default_rng(self.seed + self.epoch).permutation(self.n).tolist()
        return list(range(self.n))


_PROCESS_DATASETS: Dict[int, Any] = {}
_STOP_AT_EXIT: List[bool] = []


def stop_worker_servers() -> None:
    """Stop the forkserver that starts the pools' workers, then the
    resource tracker, and wait for both (idempotent; a later pool starts
    them again).  Left to themselves they exit only once they see this
    process's end of their pipes close, that is a moment after it has
    exited, so a program that must leave no process behind calls this
    after closing its loaders; it also runs at exit, once the pools have
    been shut down."""
    from multiprocessing import forkserver, resource_tracker

    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


def _worker_init(key: int, dataset: Any) -> None:
    """Pool initializer: each worker unpickles the dataset once (the warmed
    processor caches ride along) and serves fetches from it."""
    _PROCESS_DATASETS[key] = dataset


def _process_fetch(key: int, idx: int, entropy):
    """A worker's sample ``idx``, its host generators seeded by ``entropy``
    ((seed, epoch, idx)); only these small arguments and the sample dict
    cross the pipe per call."""
    dataset = _PROCESS_DATASETS[key]
    dataset.seed_sample(entropy)
    return dataset[idx]


class DataLoader:
    """Assemble samples into collated fixed-shape batches.

    ``num_workers > 0`` assembles them in a pool of that many processes
    (forkserver: safe beside the trainer's threads), as the reference's
    torch DataLoader does (multi_dataset.py:254-272): the per-sample python
    loops (OCR grid assembly, m4c_answer matching) hold the GIL.  The pool
    persists across epochs until ``close``.
    """

    def __init__(
        self,
        dataset: Any,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
        num_workers: int = 0,
        pad_last: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.num_workers = num_workers
        self._pool = None
        # pad the final partial batch to full size (repeating trailing
        # samples) so every batch has one static shape; host["n_valid"]
        # records the real count
        self.pad_last = pad_last
        self.sampler = EpochSampler(len(dataset), shuffle=shuffle, seed=seed)

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)

    def __len__(self) -> int:
        n = self.sampler.n
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _emit(self, samples: List[Any], n_real: int) -> Dict[str, Any]:
        batch = collate(samples)
        batch["host"]["n_valid"] = n_real
        if self.num_workers <= 0 and hasattr(self.dataset, "rng_state"):
            # the samples were drawn here, in order: this is the state the
            # next batch starts from
            batch["host"]["data_rng"] = self.dataset.rng_state()
        return batch

    def _fetch(self, chunk: List[int]) -> List[Any]:
        if self.num_workers <= 0:
            return [self.dataset[i] for i in chunk]
        key = id(self.dataset)
        if self._pool is None:
            import multiprocessing as mp
            from concurrent.futures import ProcessPoolExecutor

            ctx = mp.get_context("forkserver")
            # the server imports this module (and torch) once, before it
            # starts; each worker forks from it instead of importing anew
            ctx.set_forkserver_preload([__name__])
            if not _STOP_AT_EXIT:
                atexit.register(stop_worker_servers)
                _STOP_AT_EXIT.append(True)
            self._pool = ProcessPoolExecutor(
                max_workers=self.num_workers, mp_context=ctx,
                initializer=_worker_init, initargs=(key, self.dataset))
        s = self.sampler
        return list(self._pool.map(
            _process_fetch, [key] * len(chunk), chunk, [(s.seed, s.epoch, i) for i in chunk],
            chunksize=max(1, self.batch_size // (4 * self.num_workers))))

    def close(self) -> None:
        """Shut down the worker pool and wait for its processes
        (idempotent; a later batch starts a new pool)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        return self.iter_from(0)

    def iter_from(self, start_batch: int) -> Iterator[Dict[str, Any]]:
        """The epoch's batches from index ``start_batch`` on (the earlier
        ones are skipped without being assembled)."""
        indices = self.sampler.indices()
        for start in range(start_batch * self.batch_size, len(indices), self.batch_size):
            chunk = indices[start : start + self.batch_size]
            n_real = len(chunk)
            if n_real < self.batch_size:
                if self.drop_last:
                    return
                if self.pad_last:
                    chunk = chunk + [chunk[-1]] * (self.batch_size - n_real)
            yield self._emit(self._fetch(chunk), n_real)


def infinite_batches(
    loader: DataLoader, start_epoch: int = 0, start_batch: int = 0
) -> Iterator[Dict[str, Any]]:
    """Epoch-incrementing endless iterator (the trainer counts iterations,
    not epochs — reference: base_trainer.py:216-245).

    ``start_epoch`` and ``start_batch`` resume the epoch-seeded shuffle
    where a restored checkpoint left off (the reference restores
    current_epoch and re-seeds the sampler with it: checkpoint.py:131-136,
    base_trainer.py:216-223); each batch's host dict gets its ``epoch``
    and ``epoch_batch`` (index in the epoch), which the trainer keeps for
    its next checkpoint."""
    for epoch in itertools.count(start_epoch):
        loader.set_epoch(epoch)
        first = start_batch if epoch == start_epoch else 0
        for i, batch in enumerate(loader.iter_from(first), first):
            batch["host"]["epoch"], batch["host"]["epoch_batch"] = epoch, i
            yield batch


def prefetch_batches(
    it: Iterator[Dict[str, Any]],
    size: int = 2,
    device_put: Optional[Callable] = None,
    keep_host: bool = False,
) -> Iterator[Dict[str, Any]]:
    """Background-thread prefetch; optionally map the tensor subtrees.

    Overlaps host-side batch assembly with device compute.  ``device_put``
    runs on the thread over each batch's tensors (the trainer pins them
    there; the copies to the card are issued by the consuming thread, on
    its stream, so they stay in order with the compute).

    ``keep_host`` preserves the original numpy tensors under
    "tensors_host" (metrics/decoding consumers read them on the host).
    Worker exceptions re-raise in the consumer instead of silently ending
    the stream.  Closing the generator stops the thread and waits for it.
    """
    q: "queue_mod.Queue" = queue_mod.Queue(maxsize=size)
    sentinel = object()
    stop = threading.Event()

    def _put(item) -> bool:
        # bounded put that gives up when the consumer is gone: a plain
        # q.put would block a worker forever if the generator is
        # abandoned mid-stream (eval raising, an early break), leaking
        # one thread per abandoned prefetch
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue_mod.Full:
                continue
        return False

    def worker():
        try:
            for batch in it:
                if device_put is not None:
                    batch = dict(batch)
                    if keep_host:
                        batch["tensors_host"] = batch["tensors"]
                    batch["tensors"] = device_put(batch["tensors"])
                if not _put(batch):
                    return
        except BaseException as e:  # propagate into the consuming thread
            _put(("__prefetch_error__", e))
        finally:
            _put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                return
            if isinstance(item, tuple) and len(item) == 2 and item[0] == "__prefetch_error__":
                raise item[1]
            yield item
    finally:
        stop.set()
        try:  # unblock a worker waiting on a full queue
            while True:
                q.get_nowait()
        except queue_mod.Empty:
            pass
        # the worker stops at its next put: wait for it, so that no batch
        # is being assembled (torch work on a daemon thread) when the
        # process exits
        t.join(timeout=60)
