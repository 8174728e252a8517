"""Prefetching batch loader over shared-memory slots
(repsurf_tpu/runtime/loader.py ``PrefetchLoader``).

Worker processes run the host's numpy pipeline (augment, voxelize, crop,
pad) and write each finished batch into a ring of slots: CPU tensors in
shared memory (``share_memory_``), so the trainer reads them without a
copy.  Batch order and seeds are the JAX loader's: an epoch's order is
shuffled by ``RandomState(seed + epoch)``, and batch i of epoch e is built
by ``make_batch(indices, seed + e * 100003 + i)``, whichever worker builds
it.  Workers never touch CUDA.  They start with ``spawn`` (forking a
process that runs CUDA and thread pools is unsafe), so ``make_batch`` must
pickle: a module-level function or an instance of a module-level class.

``epoch(e, upload=...)`` hands each batch to ``upload`` (``to_device``:
a copy into a pinned staging buffer of the slot's own, then a
``non_blocking`` copy to the card, with a CUDA event recorded after it) and
yields what ``upload`` returns; a slot goes back to the workers only after
its event has completed, so no worker overwrites a batch the card is still
reading.
"""

import queue as queue_mod
import threading
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

LIFE_CHECK_S = 5.0  # a wait for a batch this long checks that the workers live


class PrefetchLoader:
    """Ring-buffered multi-process batch loader.

    Args:
      make_batch: callable (indices, seed) -> dict of numpy arrays of fixed
        shapes and dtypes (the padded batch).
      n_items: dataset length.
      batch_size: indices a batch.
      n_workers: worker processes (0: built in process, in order).
      n_slots: ring depth (at least 2 with workers).
      seed: base seed.
      shuffle, drop_last: the epoch's order and its last short batch.
    """

    def __init__(self, make_batch, n_items, batch_size, n_workers=2, n_slots=4, seed=0,
                 shuffle=True, drop_last=True):
        self.make_batch = make_batch
        self.n_items = n_items
        self.batch_size = batch_size
        self.n_workers = n_workers
        self.n_slots = max(2, n_slots) if n_workers else 1
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._slots = None
        self._staging = {}
        self._procs = []
        self._starter = None
        self._start_error = None
        self._task_q = None
        self._done_q = None

    def batch_seed(self, epoch, i):
        return self.seed + epoch * 100003 + i

    def batches_for_epoch(self, epoch):
        """The epoch's index lists, in order."""
        order = np.arange(self.n_items)
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(order)
        stop = self.n_items - self.n_items % self.batch_size if self.drop_last else self.n_items
        return [order[s:s + self.batch_size] for s in range(0, stop, self.batch_size)]

    # -- workers --------------------------------------------------------
    @staticmethod
    def _worker(make_batch, slots, task_q, done_q):
        torch.set_num_threads(1)
        while True:
            task = task_q.get()
            if task is None:
                return
            slot, i, indices, seed = task
            try:
                batch = make_batch(indices, seed)
                for k, v in batch.items():
                    slots[slot][k].numpy()[...] = v
                done_q.put((slot, i, None))
            except Exception:  # the trainer raises it
                done_q.put((slot, i, traceback.format_exc()))

    def _start(self, template):
        self._slots = [{k: torch.from_numpy(np.zeros_like(v)).share_memory_()
                        for k, v in template.items()} for _ in range(self.n_slots)]
        ctx = mp.get_context("spawn")
        self._task_q, self._done_q = ctx.Queue(), ctx.Queue()
        self._procs = [ctx.Process(target=self._worker, daemon=True,
                                   args=(self.make_batch, self._slots, self._task_q,
                                         self._done_q)) for _ in range(self.n_workers)]
        # a spawned worker imports torch and the caller's modules before its
        # first task (seconds on a busy host): start them beside the trainer,
        # which goes on with the first batch, built here
        self._starter = threading.Thread(target=self._start_workers, daemon=True)
        self._starter.start()

    def _start_workers(self):
        try:
            for p in self._procs:
                p.start()
        except Exception:  # the trainer raises it
            self._start_error = traceback.format_exc()

    def _wait_done(self):
        """(slot, batch index, a worker's traceback or None) of the next
        batch a worker finished."""
        while True:
            try:
                return self._done_q.get(timeout=LIFE_CHECK_S)
            except queue_mod.Empty:
                if self._start_error is not None:
                    raise RuntimeError(f"loader workers did not start:\n{self._start_error}")
                dead = [p.pid for p in self._procs if p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"loader workers {dead} died") from None

    # -- iteration ------------------------------------------------------
    def epoch(self, epoch, upload=None):
        """Yield the epoch's batches in order: ``upload(batch, slot)`` of
        each (see ``to_device``), or the slot's CPU tensors themselves, which
        stay valid until the next batch is asked for."""
        batches = self.batches_for_epoch(epoch)
        if not batches:
            return
        seeds = [self.batch_seed(epoch, i) for i in range(len(batches))]
        if self.n_workers == 0:
            for idxs, seed in zip(batches, seeds):
                batch = {k: torch.from_numpy(v) for k, v in self.make_batch(idxs, seed).items()}
                if upload is None:
                    yield batch
                else:
                    out, event = upload(batch, 0)
                    yield out
                    event.synchronize()
            return
        done = {}  # batch index -> its slot, built and not yet yielded
        if self._slots is None:
            # the first batch is built here: it fixes the slots' shapes
            first = self.make_batch(batches[0], seeds[0])
            self._start(first)
            for k, v in first.items():
                self._slots[0][k].numpy()[...] = v
            done[0], nxt, free = 0, 1, list(range(1, self.n_slots))
        else:
            nxt, free = 0, list(range(self.n_slots))
        inflight = 0
        try:
            for i in range(len(batches)):
                while free and nxt < len(batches):
                    self._task_q.put((free.pop(), nxt, batches[nxt], seeds[nxt]))
                    nxt += 1
                    inflight += 1
                while i not in done:
                    slot, j, err = self._wait_done()
                    inflight -= 1
                    if err is not None:
                        raise RuntimeError(f"a loader worker failed on batch {j}:\n{err}")
                    done[j] = slot
                slot = done.pop(i)
                if upload is None:
                    yield self._slots[slot]
                else:
                    out, event = upload(self._slots[slot], slot)
                    yield out
                    event.synchronize()
                free.append(slot)
        finally:
            while inflight:  # a consumer that stopped early: drain the ring
                self._wait_done()
                inflight -= 1

    def to_device(self, device):
        """An ``upload`` for ``epoch``: the slot's tensors copied into a
        pinned staging buffer of that slot, then to ``device`` with
        ``non_blocking=True`` -> (device batch, the CUDA event recorded
        after the copies)."""
        def upload(batch, slot):
            staging = self._staging.get(slot)
            if staging is None:
                staging = {k: torch.empty_like(v).pin_memory() for k, v in batch.items()}
                self._staging[slot] = staging
            out = {}
            for k, v in batch.items():
                staging[k].copy_(v)
                out[k] = staging[k].to(device, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            return out, event

        return upload

    def close(self):
        """Stop and join every worker and release the slots."""
        if self._starter is not None:
            self._starter.join()
            self._starter = None
        for _ in self._procs:
            self._task_q.put(None)
        for p in self._procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
                p.join()
        self._procs = []
        for q in (self._task_q, self._done_q):
            if q is not None:
                q.close()
                q.join_thread()
        self._task_q = self._done_q = None
        self._slots = None
        self._staging = {}
