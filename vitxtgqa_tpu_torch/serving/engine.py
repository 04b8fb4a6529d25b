"""Dynamic-batching serving engine for the inference-only model.

Counterpart of vitxtgqa_tpu/serving/engine.py, with the same API:
``submit`` returns a Future, ``warmup``, ``stop``, a ladder of batch
buckets (a group is padded with copies of its first sample up to the next
bucket and sliced back) and a batching window measured from the first
queued request of a group.

A dispatch thread groups, pads and launches each forward (CUDA launches
are asynchronous, so it goes on grouping while the card computes); a
completion thread moves each group's outputs to the host with a single
``.cpu()`` and resolves the futures.  Each group's gumbel noise comes from
a ``torch.Generator`` seeded from ``(rng_seed, group_id)``, so runs are
reproducible given the same grouping, and co-batched requests share one
draw like the rows of one eval batch.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch


def group_generator(rng_seed: int, group_id: int, device) -> torch.Generator:
    """The gumbel generator of one group."""
    seed = np.random.SeedSequence([int(rng_seed), int(group_id) % 2**32]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(seed))


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.ascontiguousarray(v)).to(device, non_blocking=True)
            for k, v in batch.items()}


def _to_host(out: Dict[str, Any], b: int) -> Dict[str, Any]:
    """Move the batch-dim tensors of ``out`` to the host with ONE copy:
    they are packed as bytes into one device buffer.  bfloat16 becomes
    float32 (numpy has no bfloat16).  Other values pass through."""
    keys = [k for k, v in out.items() if torch.is_tensor(v) and v.ndim and v.shape[0] == b]
    tensors = [out[k].float() if out[k].dtype == torch.bfloat16 else out[k] for k in keys]
    flat = [t.contiguous().view(-1).view(torch.uint8) for t in tensors]
    host = torch.cat(flat).cpu().numpy() if flat else np.zeros(0, np.uint8)
    res = {k: v for k, v in out.items() if k not in keys}
    off = 0
    for k, t, f in zip(keys, tensors, flat):
        n = f.numel()
        np_dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        res[k] = host[off: off + n].view(np_dtype).reshape(tuple(t.shape))
        off += n
    return res


class ServingEngine:
    """Batch, pad, and dispatch single-sample requests to the model.

    model: an inference-only module whose ``forward(batch, gumbel)``
      returns a dict of per-row outputs (pos_scores / ground_frame /
      ground_box) and scalar diagnostics; its parameters live on
      ``model.opts.device``.
    buckets: ascending batch sizes; the largest caps a group.
    max_wait_ms: batching window from the first queued request of a group.
    """

    def __init__(self, model, buckets: Sequence[int] = (8, 48, 192, 576),
                 max_wait_ms: float = 5.0, rng_seed: int = 0):
        if list(buckets) != sorted(set(int(b) for b in buckets)):
            raise ValueError(f"buckets must be ascending and unique: {buckets}")
        self.model = model
        self.device = model.opts.device
        self.buckets = [int(b) for b in buckets]
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self.rng_seed = int(rng_seed)
        self._group_counter = 0
        self._queue: "queue.Queue" = queue.Queue()
        self._stopped = threading.Event()
        # at most 4 groups in flight: the dispatcher blocks under overload
        self._completion: "queue.Queue" = queue.Queue(maxsize=4)
        self._thread = threading.Thread(target=self._dispatch_loop, daemon=True)
        self._completer = threading.Thread(target=self._complete_loop, daemon=True)
        self._thread.start()
        self._completer.start()

    def step(self, batch: Dict[str, np.ndarray], group_id: int) -> Dict[str, Any]:
        """One forward of a padded batch with the group's gumbel generator
        (outputs stay on the device)."""
        with torch.inference_mode():
            return self.model(self.copy_in(batch),
                              group_generator(self.rng_seed, group_id, self.device))

    def copy_in(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """The padded batch on the model's device (one copy an array, from
        pageable host memory)."""
        return to_device(batch, self.device)

    # -- client API ---------------------------------------------------------
    def submit(self, sample: Dict[str, np.ndarray]) -> Future:
        """Enqueue one sample (the batch dict WITHOUT the batch dim);
        returns a Future resolving to the per-row output dict."""
        if self._stopped.is_set():
            raise RuntimeError("engine stopped")
        fut: Future = Future()
        self._queue.put((sample, fut))
        return fut

    def warmup(self, example: Dict[str, np.ndarray],
               buckets: Optional[Sequence[int]] = None) -> None:
        """Run each bucket once (kernel build, allocator warm-up)."""
        for b in buckets or self.buckets:
            batch = {k: np.broadcast_to(v, (b,) + np.shape(v)).copy() for k, v in example.items()}
            _to_host(self.step(batch, -1), b)

    def stop(self) -> None:
        self._stopped.set()
        self._queue.put(None)  # unblock the dispatcher
        self._thread.join(timeout=10)
        self._completion.put(None)
        self._completer.join(timeout=60)
        # fail any request that raced the shutdown instead of hanging it
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item[1].done():
                item[1].set_exception(RuntimeError("engine stopped"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    # -- dispatch -----------------------------------------------------------
    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _collect_group(self):
        """Block for the first request, then drain until the largest bucket
        fills or the batching window closes."""
        first = self._queue.get()
        if first is None:
            return None
        group = [first]
        t0 = time.monotonic()
        while len(group) < self.buckets[-1]:
            remaining = self.max_wait_s - (time.monotonic() - t0)
            if remaining <= 0:
                break
            try:
                item = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:
                break
            group.append(item)
        return group

    def _dispatch_loop(self):
        while not self._stopped.is_set():
            group = self._collect_group()
            if not group:
                continue
            samples = [s for s, _ in group]
            futures = [f for _, f in group]
            n = len(samples)
            b = self._bucket_for(n)
            try:
                batch = {
                    key: np.stack([s[key] for s in samples] + [samples[0][key]] * (b - n))
                    for key in samples[0]
                }
                gid = self._group_counter
                self._group_counter += 1
                self._completion.put((self.step(batch, gid), futures, b))
            except Exception as e:  # surface errors in the callers
                for fut in futures:
                    if not fut.done():
                        fut.set_exception(e)

    def _complete_loop(self):
        while True:
            item = self._completion.get()
            if item is None:
                break
            out_dev, futures, b = item
            try:
                out = _to_host(out_dev, b)
                for i, fut in enumerate(futures):
                    row = {k: v[i] if isinstance(v, np.ndarray) and v.ndim and v.shape[0] == b else v
                           for k, v in out.items()}
                    fut.set_result(row)
            except Exception as e:
                for fut in futures:
                    if not fut.done():
                        fut.set_exception(e)
