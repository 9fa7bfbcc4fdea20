"""Minimal multi-threaded prefetching batch loader (numpy in, numpy out).

The port's own copy of `unet_goolenet_tpu/data/loader.py`: the same batches
in the same order for the same seed, so both packages train on the same
stream. Used in place of torch.utils.data.DataLoader for that reason. Threads (not processes) because the datasets
are cv2/PIL-bound and release the GIL during decode; prefetching overlaps host IO
with device steps. The reference had to force num_workers=0 for stage 2 because it
ran CUDA inside __getitem__ (ROI_main.py:290-291) — our datasets are pure host code,
so prefetch always works.

Robustness: dataset exceptions propagate to the consumer (no deadlock, no silent
short epochs), and in-flight decoded batches are bounded by `prefetch` via a slot
semaphore (out-of-order completion cannot buffer unboundedly).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np


def _collate(items: List[Dict]) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], str):
            out[key] = vals  # type: ignore[assignment]
        else:
            out[key] = np.stack(vals)
    return out


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 2,
        prefetch: int = 4,
        seed: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self._epoch = 0
        self._seed = seed

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self._seed + self._epoch)
            rng.shuffle(order)
        self._epoch += 1

        batches = [
            order[i : i + self.batch_size]
            for i in range(0, n, self.batch_size)
        ]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()

        work: "queue.Queue[Optional[int]]" = queue.Queue()
        done: "queue.Queue" = queue.Queue()
        # bounds decoded-but-unconsumed batches (including out-of-order ones)
        slots = threading.Semaphore(self.prefetch)
        stop = threading.Event()

        for bi in range(len(batches)):
            work.put(bi)
        for _ in range(self.num_workers):
            work.put(None)

        def worker():
            while not stop.is_set():
                # acquire the slot BEFORE taking a work item: work is FIFO, so the
                # <= prefetch in-flight/unconsumed batches are always the OLDEST
                # ones — the consumer's next batch is always assigned to a worker
                # that holds a slot, which rules out the ordering deadlock where
                # both slots are held by newer out-of-order results
                slots.acquire()
                if stop.is_set():
                    return
                bi = work.get()
                if bi is None:
                    slots.release()
                    return
                try:
                    batch = _collate([self.dataset[int(i)] for i in batches[bi]])
                except BaseException as exc:  # propagate, don't deadlock
                    done.put(("error", bi, exc))
                    return
                done.put(("ok", bi, batch))

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()

        results: Dict[int, Dict] = {}
        next_bi = 0
        try:
            while next_bi < len(batches):
                if next_bi in results:
                    out = results.pop(next_bi)
                    next_bi += 1
                    slots.release()
                    yield out
                    continue
                kind, bi, payload = done.get()
                if kind == "error":
                    raise RuntimeError(
                        f"DataLoader worker failed on batch {bi}"
                    ) from payload
                results[bi] = payload
        finally:
            stop.set()
            # unblock any worker waiting on a slot
            for _ in threads:
                slots.release()
            for t in threads:
                t.join(timeout=0.5)
