"""DataLoader and device_prefetch (port of paddle_tpu's `io/dataloader.py`).

`DataLoader(dataset, ...)` takes the JAX package's whole signature.
Samples are collated on the host into numpy trees (`default_collate_fn`,
the JAX package's rules), and `iter(loader)` yields them as paddle
`Tensor`s on `places` (the first of a list) or on the default device
(`set_device`; cuda, which raises without a GPU). With `batch_size=None`
each sample is a batch. An `IterableDataset` is batched in the order it
yields.

With `num_workers=N > 0` the batches come from N worker processes,
started with the `dataloader_start_method` flag's method ("spawn", as in
the JAX package), so a dataset, its transforms and `collate_fn` must be
picklable: module-level classes and functions, not ones defined inside a
function. Batch k's indices go to worker k mod N through that worker's
own queue, at most `prefetch_factor` x N batches ahead; the parent
reorders what comes back by sequence number, so the batches arrive in
the order `num_workers=0` gives. A worker packs each batch's arrays into
one POSIX shared-memory segment (`use_shared_memory`, the default; the
segment's name starts with `SHM_PREFIX`) and sends only its layout; the
parent copies the arrays out and unlinks the segment. Object-dtype and
non-array leaves travel pickled, as in the JAX package. A worker's
exception is raised in the parent with the worker's traceback; a worker
that dies, or no batch within `timeout` seconds (when set), raises. The
workers stop, and the segments in flight are unlinked, when the
iterator is exhausted, raises or is dropped (an early `break`), and at
exit; `persistent_workers=True` keeps them from one epoch to the next,
until the loader is dropped.

Worker w seeds numpy's global generator and Python's `random` with
`base_seed + w`. The JAX package seeds numpy only, so a transform that
draws from `random` (every random one of `vision.transforms`) is not
reproducible from the seed in its workers; the port does not copy that
fault. The base seed is derived from numpy's global generator state and
the number of worker starts the loader has made, without drawing from
the generator: a loader with workers shuffles exactly as one without
does (the JAX package draws it, which moves the shuffle), and each new
start (each epoch, unless the workers persist) draws anew even when
nothing else moved numpy's generator.

`device_prefetch(loader_or_iterator, depth=2, place=None)` places
upcoming batches on the device, `depth` batches ahead. Given a
`DataLoader`, it takes the loader's host batches, so the copy happens
there and only there. Over a loader with workers a feeder thread takes
the batches and, on CUDA, copies each into pinned memory and from there
to the device on a side stream, `non_blocking`, and records an event;
the consumer's stream waits on that event, and each tensor is marked
with `record_stream` for the consumer's stream, so the caching allocator
does not hand its memory to a later copy while the step still reads it.
So a batch's unpacking, pinning and copy overlap the step. Over anything
else, whose batches are made in this process and whose host time sets
the pace, the next batches are fetched and their copies issued from
pageable memory on the consumer's thread and current stream before the
one ahead of them is handed over: there a second Python thread only
takes the interpreter lock from the step, and pinning a batch, or a
pageable copy on a side stream, costs the host more than the copy on the
current stream (tools/fit_host_profile.py). `place` (a callable leaf ->
device tensor, such as `CompiledTrainStep.put_batch`) is called under
the side stream where there is one; an error it raises reaches the
consumer (the JAX function returns the leaf unplaced instead), after the
batches before it.
"""
from __future__ import annotations

import collections
import itertools
import multiprocessing as mp
import os
import queue
import random
import threading
import time
import traceback
import uuid
import weakref
import zlib
from multiprocessing import shared_memory as shm_mod

import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..core.arrays import to_numpy
from ..core.device import default_device
from ..core.flags import define_flag, get_flags
from ..core.place import to_torch_device
from ..core.tensor import wrap
from .dataset import IterableDataset
from .sampler import BatchSampler, _batches

__all__ = ["DataLoader", "default_collate_fn", "get_worker_info",
           "device_prefetch", "SHM_PREFIX"]

define_flag("dataloader_start_method", "spawn",
            "multiprocessing start method for DataLoader workers; spawn "
            "starts each worker from a fresh interpreter, fork trades that "
            "safety for startup time.")

SHM_PREFIX = "pdtt_"            # names of the loader's shm segments

_worker_info = threading.local()


class WorkerInfo:
    def __init__(self, id, num_workers, dataset, seed):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset
        self.seed = seed


def get_worker_info():
    """In a DataLoader worker, its `WorkerInfo` (id, num_workers,
    dataset, seed); None in the main process."""
    return getattr(_worker_info, "info", None)


def default_collate_fn(batch):
    """Stack a list of samples into batched numpy arrays, recursing into
    tuples, lists and dicts: arrays and tensors stack, ints become int64,
    floats float32, strings stay a list."""
    sample = batch[0]
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, torch.Tensor):
        return np.stack([to_numpy(s) for s in batch])
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, np.int64)
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, np.float32)
    if isinstance(sample, (list, tuple)):
        return type(sample)(default_collate_fn(list(s)) for s in zip(*batch))
    if isinstance(sample, dict):
        return {k: default_collate_fn([s[k] for s in batch]) for k in sample}
    if isinstance(sample, (str, bytes)):
        return batch
    return np.asarray(batch)


def _tree_map(fn, obj):
    """Map fn over the non-container leaves of a list/tuple/dict tree."""
    if isinstance(obj, (list, tuple)):
        return type(obj)(_tree_map(fn, v) for v in obj)
    if isinstance(obj, dict):
        return {k: _tree_map(fn, v) for k, v in obj.items()}
    return fn(obj)


def _tree_leaves(obj):
    out = []
    _tree_map(out.append, obj)
    return out


def _numeric(a):
    """A leaf that becomes a tensor: a numeric array (bf16 bits too)."""
    return isinstance(a, np.ndarray) and (
        a.dtype.kind in "biufc" or (a.dtype.kind == "V"
                                    and a.dtype.itemsize == 2))


def _host_tensor(a) -> torch.Tensor:
    """A numeric numpy leaf as a CPU tensor with `paddle.Tensor`'s dtype
    rules (float64 -> the default float dtype, bf16 bits -> bf16),
    sharing the array's memory where no cast is needed."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if t.dtype == torch.float64:
        t = t.to(dtype_mod.get_default_dtype())
    return t


def _place_leaf(v, device, place=None, non_blocking=False, pin=False):
    """One batch leaf as a `Tensor` on `device` (through `place` when
    given), from pinned memory when `pin`; a leaf that is not numeric
    passes through."""
    if isinstance(v, torch.Tensor):
        v = torch.Tensor.detach(v)
    elif _numeric(v):
        v = _host_tensor(v)
    else:
        return v
    if pin and v.device.type == "cpu":
        v = v.pin_memory()
    if place is not None:
        return wrap(place(v))
    return wrap(v.to(device, non_blocking=non_blocking,
                     copy=v.device.type == "cpu" == device.type))


def _on_device(tree, device):
    """A host batch as `Tensor`s on `device`, copied from pageable memory
    on the current stream (`device_prefetch` is the overlapped route)."""
    return _tree_map(lambda v: _place_leaf(v, device, non_blocking=True),
                     tree)


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, use_shared_memory=True,
                 prefetch_factor=2, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        self.dataset = dataset
        self.feed_list = feed_list
        self.places = places
        self.return_list = return_list
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = max(0, int(num_workers))
        self.use_shared_memory = bool(use_shared_memory)
        self.prefetch_factor = max(1, int(prefetch_factor))
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self.persistent_workers = bool(persistent_workers)
        self.drop_last = bool(drop_last)
        self._persistent_iter = None
        self._worker_starts = 0
        self._iterable_dataset = isinstance(dataset, IterableDataset)
        self.batch_size = batch_size
        if batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = getattr(batch_sampler, "batch_size",
                                      batch_size)
        elif self._iterable_dataset or batch_size is None:
            self.batch_sampler = None
        else:
            self.batch_sampler = BatchSampler(
                dataset=dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)

    def __len__(self):
        if self._iterable_dataset:
            raise TypeError("IterableDataset has no len()")
        if self.batch_sampler is None:
            return len(self.dataset)
        return len(self.batch_sampler)

    def _device(self) -> torch.device:
        places = self.places
        if isinstance(places, (list, tuple)):
            places = places[0] if places else None
        return default_device() if places is None \
            else to_torch_device(places)

    def __iter__(self):
        device = self._device()
        return (_on_device(b, device) for b in self._host_iter())

    def __call__(self):
        return self.__iter__()

    def _host_iter(self):
        """An epoch's batches as collated host (numpy) trees."""
        if self.num_workers == 0:
            return self._single_process_iter()
        if self.persistent_workers and not self._iterable_dataset:
            it = self._persistent_iter
            if it is None or not it.alive:
                it = self._persistent_iter = _MultiprocessIter(
                    self, persistent=True)
            else:
                it.reset()
            return it
        return _MultiprocessIter(self)

    def _worker_seed(self):
        """The base seed of a worker start: from numpy's global state,
        not drawn from it, and from the count of this loader's starts."""
        self._worker_starts += 1
        state = np.random.get_state()
        return zlib.crc32(state[1].tobytes()
                          + int(state[2]).to_bytes(4, "little")
                          + self._worker_starts.to_bytes(8, "little"))

    def _single_process_iter(self):
        if self._iterable_dataset:
            return _stream_batches(self.dataset, self.batch_size,
                                   self.drop_last, self.collate_fn)
        if self.batch_sampler is None:
            return (self.dataset[i] for i in range(len(self.dataset)))
        return (self.collate_fn([self.dataset[i] for i in indices])
                for indices in self.batch_sampler)


def _stream_batches(samples, batch_size, drop_last, collate_fn):
    """An IterableDataset's samples, collated `batch_size` at a time (each
    sample a batch with batch_size=None)."""
    if batch_size is None:
        return iter(samples)
    return map(collate_fn, _batches(samples, batch_size, drop_last))


# ---------------------------------------------------------------------------
# shared-memory batch transport
# ---------------------------------------------------------------------------

class _ShmBatch:
    """Travels through the queue in place of a batch: the arrays are in
    one shm segment, only the layout is pickled."""

    def __init__(self, shm_name, layout):
        self.shm_name = shm_name
        self.layout = layout       # the tree with _ArrRef leaves


class _ArrRef:
    def __init__(self, offset, shape, dtype):
        self.offset = offset
        self.shape = shape
        self.dtype = dtype


def _pack_batch(data, name):
    """Collated tree -> (_ShmBatch, segment), the segment named `name`.
    The consumer unlinks the segment; the producer unregisters it from
    its resource tracker so that its exit does not unlink it first."""
    arrays = [a for a in _tree_leaves(data)
              if isinstance(a, np.ndarray) and not a.dtype.hasobject]
    total = sum(int(a.nbytes) for a in arrays)
    if total == 0:
        return data, None
    seg = shm_mod.SharedMemory(name=name, create=True, size=total)
    from multiprocessing import resource_tracker
    resource_tracker.unregister(seg._name, "shared_memory")
    offset = 0

    def pack_leaf(obj):
        nonlocal offset
        if not isinstance(obj, np.ndarray) or obj.dtype.hasobject:
            return obj              # pickled through the queue
        a = np.ascontiguousarray(obj)
        view = np.ndarray(a.shape, a.dtype, buffer=seg.buf, offset=offset)
        view[...] = a
        ref = _ArrRef(offset, a.shape, a.dtype)
        offset += int(a.nbytes)
        return ref

    layout = _tree_map(pack_leaf, data)
    return _ShmBatch(seg.name, layout), seg


def _unlink(name):
    """Remove segment `name` by name alone: a worker stopped between
    creating a segment and sizing it leaves an empty one, which
    `SharedMemory` cannot open (it maps what it opens)."""
    try:
        shm_mod._posixshmem.shm_unlink("/" + name)
    except FileNotFoundError:
        pass


def _unpack_batch(msg: _ShmBatch):
    seg = shm_mod.SharedMemory(name=msg.shm_name)
    try:
        def unpack_leaf(obj):
            if isinstance(obj, _ArrRef):
                view = np.ndarray(obj.shape, obj.dtype, buffer=seg.buf,
                                  offset=obj.offset)
                return view.copy()     # detach before the segment goes
            return obj

        return _tree_map(unpack_leaf, msg.layout)
    finally:
        seg.close()
        seg.unlink()


class _WorkerException:
    def __init__(self, tb):
        self.tb = tb


def _worker_loop(index_queue, out_queue, worker_id, num_workers, base_seed,
                 use_shm, shm_base):
    """One worker. Its first message is what it works on (the dataset,
    collate_fn, worker_init_fn, iterable, batch_size, drop_last): sent
    through the queue, not with the process, so that starting a worker
    does not wait for the last one to import the modules its dataset
    needs."""
    (dataset, collate_fn, init_fn, iterable, batch_size,
     drop_last) = index_queue.get()
    names = (f"{shm_base}{worker_id}_{i}" for i in itertools.count())

    def put(seq, data):
        if use_shm:
            msg, seg = _pack_batch(data, next(names))
            if seg is not None:
                seg.close()      # the segment lives until the parent unlinks
            out_queue.put((seq, msg))
        else:
            out_queue.put((seq, data))

    try:
        np.random.seed((base_seed + worker_id) % (2 ** 32))
        random.seed(base_seed + worker_id)
        _worker_info.info = WorkerInfo(worker_id, num_workers, dataset,
                                       base_seed)
        if init_fn is not None:
            init_fn(worker_id)
        if iterable:
            try:
                for batch in _stream_batches(dataset, batch_size, drop_last,
                                             collate_fn):
                    put(0, batch)
            except Exception:
                out_queue.put((0, _WorkerException(traceback.format_exc())))
            out_queue.put((None, None))         # this worker is done
            return
        while True:
            task = index_queue.get()
            if task is None:
                break
            seq, indices = task
            try:
                if indices is None:             # batch_size=None
                    put(seq, dataset[seq])
                else:
                    put(seq, collate_fn([dataset[i] for i in indices]))
            except Exception:
                out_queue.put((seq, _WorkerException(traceback.format_exc())))
    except KeyboardInterrupt:
        pass


class _Pool:
    """The worker processes and their queues. Owned by one
    `_MultiprocessIter`, and shut down when that is exhausted, raises, is
    dropped, or at exit."""

    def __init__(self, ctx, n):
        self.index_queues = [ctx.Queue() for _ in range(n)]
        self.out_queue = ctx.Queue()
        self.workers = []
        self.shm_base = f"{SHM_PREFIX}{os.getpid()}_{uuid.uuid4().hex[:8]}_"

    def shutdown(self):
        if not self.workers:
            return
        for q in self.index_queues:
            try:
                q.put(None)
            except (OSError, ValueError):
                pass
        # stop the producers first, then sweep the segments in flight: a
        # drain before terminating races with workers still packing
        for w in self.workers:
            if w.is_alive():
                w.terminate()
        for w in self.workers:
            w.join(timeout=5.0)
            if w.is_alive():            # SIGTERM not taken in time
                w.kill()
                w.join()
        self.workers = []
        try:
            while True:
                _, data = self.out_queue.get(timeout=0.05)
                if isinstance(data, _ShmBatch):
                    _unlink(data.shm_name)
        except (queue.Empty, OSError, ValueError, EOFError):
            pass
        # a worker stopped between creating a segment and sending it
        if os.path.isdir("/dev/shm"):
            for name in os.listdir("/dev/shm"):
                if name.startswith(self.shm_base):
                    _unlink(name)
        for q in self.index_queues + [self.out_queue]:
            q.cancel_join_thread()
            q.close()


class _MultiprocessIter:
    """N workers take index batches from their own queues; `__next__`
    reorders what they send back by sequence number."""

    _POLL_S = 0.25

    def __init__(self, loader: DataLoader, persistent=False):
        # what it needs of the loader, not the loader: a persistent
        # iterator is the loader's, and a cycle would keep both (and the
        # workers) alive past the loader's last reference
        self._iterable = loader._iterable_dataset
        self._batch_sampler = loader.batch_sampler
        self._n_items = None if self._iterable or loader.batch_sampler \
            else len(loader.dataset)
        self._prefetch = loader.prefetch_factor
        self._timeout = loader.timeout
        self._persistent = persistent
        ctx = mp.get_context(get_flags("dataloader_start_method"))
        n = loader.num_workers
        self._pool = pool = _Pool(ctx, n)
        self._seq_send = 0
        self._seq_rcvd = 0
        self._cache = {}
        self._exhausted_workers = 0
        base_seed = loader._worker_seed()
        iterable = self._iterable
        work = (loader.dataset, loader.collate_fn, loader.worker_init_fn,
                iterable, loader.batch_size, loader.drop_last)
        for wid in range(n):
            w = ctx.Process(
                target=_worker_loop,
                args=(pool.index_queues[wid], pool.out_queue, wid, n,
                      base_seed, loader.use_shared_memory, pool.shm_base),
                daemon=True)
            w.start()
            pool.workers.append(w)
            pool.index_queues[wid].put(work)
        self._finalizer = weakref.finalize(self, pool.shutdown)
        if not iterable:
            self._start_epoch()

    @property
    def alive(self):
        return bool(self._pool.workers)

    def _start_epoch(self):
        sampler = self._batch_sampler
        self._sampler_iter = iter(sampler) if sampler is not None \
            else iter([None] * self._n_items)
        for _ in range(len(self._pool.workers) * self._prefetch):
            self._dispatch_next()

    def _dispatch_next(self):
        try:
            indices = next(self._sampler_iter)
        except StopIteration:
            return False
        wid = self._seq_send % len(self._pool.workers)
        self._pool.index_queues[wid].put((self._seq_send, indices))
        self._seq_send += 1
        return True

    def __iter__(self):
        return self

    def close(self):
        self._finalizer()

    def __next__(self):
        if not self.alive:
            raise StopIteration
        if self._iterable:
            while True:
                if self._exhausted_workers == len(self._pool.workers):
                    self.close()
                    raise StopIteration
                seq, data = self._get()
                if seq is None:
                    self._exhausted_workers += 1
                    continue
                return self._checked(data)

        if self._seq_rcvd >= self._seq_send and not self._dispatch_next():
            if not self._persistent:
                self.close()
            raise StopIteration
        while self._seq_rcvd not in self._cache:
            seq, data = self._get()
            self._cache[seq] = data
        data = self._cache.pop(self._seq_rcvd)
        self._seq_rcvd += 1
        self._dispatch_next()
        return self._checked(data)

    def _checked(self, data):
        if isinstance(data, _WorkerException):
            self.close()
            raise RuntimeError("DataLoader worker failed:\n" + data.tb)
        return data

    def reset(self):
        """Re-arm a persistent iterator for the next epoch: take (and
        unlink) the batches an abandoned epoch left in flight, restart
        the sampler, prime the workers again."""
        for _ in range(self._seq_send - self._seq_rcvd - len(self._cache)):
            self._get()
        self._cache.clear()
        self._seq_rcvd = self._seq_send
        self._start_epoch()

    def _get(self):
        """The next (seq, batch) from any worker, its segment copied out
        and unlinked. Raises when a worker died or, with the loader's
        `timeout`, when nothing came in time."""
        timeout = self._timeout
        t0 = time.monotonic()
        while True:
            try:
                seq, data = self._pool.out_queue.get(timeout=self._POLL_S)
            except queue.Empty:
                dead = [w for w in self._pool.workers if not w.is_alive()]
                if dead and self._exhausted_workers < len(dead):
                    codes = [w.exitcode for w in dead]
                    self.close()
                    raise RuntimeError(
                        f"DataLoader: {len(dead)} worker(s) died "
                        f"unexpectedly (exit codes {codes})") from None
                if timeout and time.monotonic() - t0 > timeout:
                    self.close()
                    raise RuntimeError(f"DataLoader timed out: no batch in "
                                       f"{timeout} s") from None
                continue
            if isinstance(data, _ShmBatch):
                data = _unpack_batch(data)
            return seq, data


# ---------------------------------------------------------------------------
# device prefetch
# ---------------------------------------------------------------------------

def device_prefetch(iterator, sharding=None, depth=2, place=None):
    """Yield the batches of `iterator` (a `DataLoader`, or any iterator of
    batches) already on the device, placed up to `depth` batches ahead
    (see the module docstring). `place`, when given, places each leaf;
    otherwise leaves go to the loader's device or the default one. An
    exception of the iterator or of `place` is raised in the consumer
    after the batches before it; leaving the loop early stops the
    feeder, if there is one, before the generator returns."""
    if sharding is not None:
        raise NotImplementedError(
            "device_prefetch(sharding=): multi-GPU placement is not ported "
            "to paddle_tpu_torch (ROADMAP queue 1 item 7)")
    threaded = False
    device = default_device()
    if isinstance(iterator, DataLoader):
        threaded = iterator.num_workers > 0
        device = iterator._device()
        iterator = iterator._host_iter()
    side = torch.cuda.Stream(device=device) \
        if threaded and device.type == "cuda" else None

    def one(x):
        return _place_leaf(x, device, place, non_blocking=True,
                           pin=side is not None)

    def put(tree):
        if side is None:
            return tree, _tree_map(one, tree), None
        with torch.cuda.stream(side):
            out = _tree_map(one, tree)
            ev = torch.cuda.Event()
            ev.record(side)
        return tree, out, ev

    def hand_over(item):
        _host, out, ev = item     # _host: the source stays referenced
        if ev is not None:
            cur = torch.cuda.current_stream(device)
            cur.wait_event(ev)
            for leaf in _tree_leaves(out):
                if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
                    torch.Tensor.record_stream(leaf, cur)
        return out

    if threaded:
        return _threaded_prefetch(iter(iterator), put, hand_over, depth)
    return _inline_prefetch(iter(iterator), put, hand_over, depth)


def _inline_prefetch(source, put, hand_over, depth):
    """Fetch and place up to `depth` batches, then hand over the oldest:
    the copy of the next batch is under way while the step of this one
    is queued."""
    pending = collections.deque()
    more = True
    while True:
        while more and len(pending) < depth:
            try:
                pending.append(put(next(source)))
            except StopIteration:
                more = False
            except Exception as e:      # raised after the batches before
                pending.append(e)
                more = False
        if not pending:
            return
        item = pending.popleft()
        if isinstance(item, Exception):
            raise item
        yield hand_over(item)
        del item


def _threaded_prefetch(source, put, hand_over, depth):
    """A feeder thread fetches and places batches into a queue of
    `depth`; the consumer hands them over in order."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    done = object()
    stop = threading.Event()

    def offer(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def feeder():
        try:
            for item in source:
                if not offer(put(item)):
                    return            # the consumer left
        except BaseException as e:    # raised in the consumer
            offer(e)
            return
        offer(done)

    t = threading.Thread(target=feeder, name="device_prefetch feeder",
                         daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                break
            if isinstance(item, BaseException):
                raise item
            yield hand_over(item)
            del item
    finally:
        # unblock the feeder and wait until it has left the source: a
        # persistent loader's next epoch re-arms that same iterator
        stop.set()
        t.join()
