"""Host-streaming data: a training split that stays on the host. Counterpart
of generative_models_tpu/data/stream.py.

StreamingDataset keeps the training split on the host (anything with numpy
fancy indexing: an ndarray, an np.memmap or np.lib.format.open_memmap, so
the split need not fit in host memory either) and streams shuffled batches
to the device through a daemon producer thread and a bounded queue,
prefetch deep:

  * an epoch's order is the on-device Dataset's (data/mnist.py):
    torch.randperm(n, generator)[:steps * bs], cut into batches, so a
    streamed epoch yields exactly the on-device epoch's batches from the
    same generator, and --stream_data=1 trains the run of --stream_data=0;
  * the producer reads each batch in sorted index order (sequential reads
    of a memmap) and puts it back in the epoch's order, applies the
    optional transform, then copies it to the device;
  * on the card it copies from pinned host buffers with non_blocking=True
    on a side stream of its own, entering the device and that stream
    itself (both are per thread), and records an event; the consumer's
    stream waits on the event before it reads the batch, and the batch is
    marked as used by that stream (record_stream), so its memory is not
    handed out again before the step that reads it is done;
  * chunk > 1 stages stacked (chunk, bs, ...) blocks in the same order, the
    last one partial when chunk does not divide the epoch; the device
    holds at most prefetch x chunk batches ahead of the consumer.

close() (or leaving the with block, or running the iterator out) stops the
producer and joins it, so breaking out of an epoch leaks no thread; an
exception in the producer is raised again in the consumer.

The test split lives on the device, with the on-device Dataset's surface
(epoch_batches(train=False), first_test_batch); epoch_batches(train=True)
is refused: the harness iterates stream_epoch instead (main.py routes on
is_streaming).
"""

import queue
import threading

import numpy as np
import torch

from generative_models_tpu_torch.data.mnist import Dataset, local_rows

_END = object()


class _PrefetchIterator:
    """Device batches from a producer thread through a bounded queue."""

    def __init__(self, produce, depth, device):
        self._q = queue.Queue(maxsize=max(1, int(depth)))
        self._stop = threading.Event()
        self._err = None
        self._done = False
        self._device = device
        self._thread = threading.Thread(target=self._work, args=(produce,), daemon=True)
        self._thread.start()

    def _put(self, item):
        """A put that gives up when close() is called."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _work(self, produce):
        try:
            for item in produce():
                if not self._put(item):
                    return  # closed in the middle of the epoch
        except BaseException as e:  # raised again in __next__
            self._err = e
        self._put(_END)

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        item = self._q.get()
        if item is _END:
            self._done = True
            self._thread.join()
            if self._err is not None:
                raise self._err
            raise StopIteration
        x, y, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(event)
            x.record_stream(stream)
            y.record_stream(stream)
        return x, y

    def close(self):
        """Stop the producer, drop what it staged and join it."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
        self._done = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class StreamingDataset:
    """train_x, train_y: host arrays with numpy fancy indexing, read a batch
    at a time. test_x, test_y: placed on the device whole. transform: a
    host callable applied to each image batch before its copy (and to the
    test split once), e.g. a uint8 split on disk made float32."""

    is_streaming = True

    def __init__(self, train_x, train_y, test_x, test_y, bs, device, prefetch=2,
                 transform=None):
        self.bs = int(bs)
        self.device = torch.device(device)
        self.prefetch = int(prefetch)
        self.transform = transform
        self.train_x, self.train_y = train_x, train_y
        tx = np.asarray(test_x)
        if transform is not None:
            tx = np.asarray(transform(tx))
        self.test_x = torch.as_tensor(tx).to(self.device)
        self.test_y = torch.as_tensor(np.asarray(test_y)).to(self.device)
        self.steps_per_epoch = train_x.shape[0] // self.bs  # drop_last semantics
        self.test_steps = self.test_x.shape[0] // self.bs

    def _host_batch(self, idx):
        """The images and labels at idx (in idx's order), read in sorted
        order, then transformed."""
        order = np.argsort(idx, kind='stable')
        bx = np.empty((len(idx), *self.train_x.shape[1:]), self.train_x.dtype)
        by = np.empty((len(idx), *self.train_y.shape[1:]), self.train_y.dtype)
        bx[order] = self.train_x[idx[order]]
        by[order] = self.train_y[idx[order]]
        if self.transform is not None:
            bx = np.asarray(self.transform(bx))
        return np.ascontiguousarray(bx), np.ascontiguousarray(by)

    def stream_epoch(self, generator, chunk=1):
        """One shuffled pass over the training split: an iterator (and a
        context manager) of (x, y) device batches, (bs, ...) or, with chunk
        > 1, stacked (k, bs, ...) blocks of k <= chunk. generator: the CPU
        torch.Generator the on-device Dataset would take for this epoch."""
        n = self.steps_per_epoch * self.bs
        perm = torch.randperm(self.train_x.shape[0], generator=generator)[:n].numpy()
        chunk = max(1, int(chunk))
        device = self.device
        if device.type == 'cuda' and device.index is None:
            device = torch.device('cuda', torch.cuda.current_device())

        def blocks():
            for s0 in range(0, self.steps_per_epoch, chunk):
                steps = min(chunk, self.steps_per_epoch - s0)
                pairs = [self._host_batch(
                    perm[(s0 + i) * self.bs:(s0 + i + 1) * self.bs][local_rows(self.bs)])
                    for i in range(steps)]
                if chunk == 1:
                    yield pairs[0]
                else:
                    yield np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])

        def produce():
            if device.type != 'cuda':
                for bx, by in blocks():
                    yield torch.from_numpy(bx), torch.from_numpy(by), None
                return
            torch.cuda.set_device(device)  # the current device is per thread
            side = torch.cuda.Stream(device)
            for bx, by in blocks():
                hx, hy = torch.from_numpy(bx).pin_memory(), torch.from_numpy(by).pin_memory()
                with torch.cuda.stream(side):
                    x = hx.to(device, non_blocking=True)
                    y = hy.to(device, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record(side)
                yield x, y, event

        return _PrefetchIterator(produce, self.prefetch, device)

    # ---- the test split: data/mnist.py's Dataset surface ----
    def epoch_batches(self, generator, train=True):
        if train:
            raise ValueError('StreamingDataset has no stacked train epoch (the split lives '
                             'on the host); iterate stream_epoch(generator) instead')
        return Dataset.epoch_batches(self, generator, train=False)

    first_test_batch = Dataset.first_test_batch
