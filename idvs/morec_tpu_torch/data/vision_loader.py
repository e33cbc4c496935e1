"""Vision batch pipeline: item ids -> transformed image batches, with a
background-thread prefetcher (JAX twin: idvs/morec_tpu/data/vision_loader.py,
copied).

Replaces the reference's 12 DataLoader worker processes doing per-sample
LMDB reads + PIL transforms (inbatch_sasrec_e2e_vision/data_utils/
dataset.py:78-99): here a whole batch's unique images are fetched from the
mmap'd store and transformed in one native multithreaded call, and the NEXT
batch is prepared on a worker thread while the device runs the current step
(double buffering).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterable, Optional

import numpy as np

from .imagestore import BatchTransform


class VisionBatchPipe:
    """id arrays -> (N, R, R, 3) image batches (uint8 by default)."""

    def __init__(self, store, item_id_to_key: Dict[int, bytes], resize: int,
                 mode: str = "u8", n_threads: Optional[int] = None):
        self.store = store
        self.item_id_to_key = item_id_to_key
        self.resize = resize
        self.transform = BatchTransform(resize, n_threads=n_threads, mode=mode)
        self.mode = mode

    def images_for(self, ids: np.ndarray) -> np.ndarray:
        """ids: any-shape int array; id 0 -> zero image (padding, reference
        dataset.py:86 zero-fills pad slots). Duplicate ids are transformed
        once and broadcast."""
        flat = np.asarray(ids).reshape(-1)
        uniq, inverse = np.unique(flat, return_inverse=True)
        imgs = []
        zero_slot = None
        for j, item in enumerate(uniq):
            if item == 0:
                zero_slot = j
                imgs.append(np.zeros((1, 1, 3), np.uint8))
            else:
                imgs.append(self.store.get(self.item_id_to_key[int(item)]))
        batch = self.transform(imgs)
        if zero_slot is not None:
            batch[zero_slot] = 0
        return batch[inverse]


class Prefetcher:
    """Wraps a batch iterator; materializes batches one step ahead on a
    worker thread (the native transform releases the GIL).

    This is the double-buffered host pipeline replacing the reference's
    12 DataLoader workers (inbatch_sasrec_e2e_vision/data_utils/
    dataset.py:78-99): image fetch + resize (and --dedup_items unique-packing)
    for step N+1 overlap the device running step N. Worker exceptions are
    re-raised in the consuming thread. ``fn`` runs on the worker thread in
    the order of ``it``, so prefetching changes no result."""

    def __init__(self, it: Iterable, fn: Callable, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._done = object()
        self._err = None

        def work():
            try:
                for raw in it:
                    self._q.put(fn(raw))
            except BaseException as e:   # propagate to the consumer
                self._err = e
            finally:
                self._q.put(self._done)

        self._t = threading.Thread(target=work, daemon=True)
        self._t.start()

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._done:
                if self._err is not None:
                    raise self._err
                return
            yield item
