"""Host-side batches and their feed to the card: the port of
``triplegan_tpu/data/pipeline.py``'s ``BatchSampler`` and
``device_prefetch``.

The host does only index sampling over the in-memory uint8 arrays (numpy's
``RandomState``, exactly as the JAX sampler draws, so the two give the same
batches bitwise for the same seed) and gathers the rows through the native
assembler (``data/native.py``); all image math happens on the device, in
the train step (``data/ondevice.py``). ``device_prefetch`` stages the next
batches onto the card while the current step runs: pinned host buffers,
copies on a side stream, and the consumer's stream ordered after them.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from triplegan_tpu_torch.data.datasets import SemiSupervisedData
from triplegan_tpu_torch.data.native import gather_rows


class BatchSampler:
    """Infinite sampler of {x_l, y_l, x_u} uint8 batches, and the fixed-shape
    test batches.

    Each stream is shuffled per epoch without replacement and reshuffles
    when it runs out, independently of the other (the labeled stream is
    much shorter than the unlabeled one, so the two cycle at different
    rates); a stream smaller than a batch is sampled with replacement.
    """

    def __init__(self, data: SemiSupervisedData, batch_size: int, seed: int = 0):
        self.data = data
        self.batch_size = batch_size
        self._rng = np.random.RandomState(seed)
        self._label_order = self._reshuffle(len(data.x_label))
        self._unlabel_order = self._reshuffle(len(data.x_unlabel))
        self._label_pos = 0
        self._unlabel_pos = 0

    def _reshuffle(self, n: int) -> np.ndarray:
        return self._rng.permutation(n)

    def _take(self, order: np.ndarray, pos: int, n_total: int):
        """(indices of the next batch, the stream's order, its position):
        the next ``batch_size`` of ``order`` from ``pos``, topped up from a
        fresh shuffle where it wraps."""
        b = self.batch_size
        if b > n_total:
            return self._rng.randint(0, n_total, size=b), order, pos
        if pos + b <= len(order):
            return order[pos:pos + b], order, pos + b
        head = order[pos:]
        order = self._reshuffle(n_total)
        need = b - len(head)
        return np.concatenate([head, order[:need]]), order, need

    def next(self, with_unlabeled: bool = True) -> Dict[str, np.ndarray]:
        idx_l, self._label_order, self._label_pos = self._take(
            self._label_order, self._label_pos, len(self.data.x_label))
        out = {"x_l": gather_rows(self.data.x_label, idx_l), "y_l": self.data.y_label[idx_l]}
        if with_unlabeled:
            idx_u, self._unlabel_order, self._unlabel_pos = self._take(
                self._unlabel_order, self._unlabel_pos, len(self.data.x_unlabel))
            out["x_u"] = gather_rows(self.data.x_unlabel, idx_u)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next()

    def next_triple(self, z_dim: int, num_classes: int,
                    skip_c_unlabeled: bool = False) -> Dict[str, Dict[str, np.ndarray]]:
        """One step's inputs for the sequential D → G → C update: fresh
        sub-batches and noise per player, as the reference's three
        ``sess.run``s each pull their own. Streams "d" and "c" hold x_l,
        y_l, x_u, z (float32) and y_g (int32); stream "g" z and y_g. With
        ``skip_c_unlabeled`` (``share_pseudo_forward``, whose C update
        reuses D's unlabeled batch) the "c" stream draws no x_u, so the
        unlabeled stream advances once a step."""
        b = self.batch_size

        def noise():
            return {"z": self._rng.normal(0, 1, size=(b, z_dim)).astype(np.float32),
                    "y_g": self._rng.randint(0, num_classes, size=(b,)).astype(np.int32)}

        d = self.next()
        d.update(noise())
        c = self.next(with_unlabeled=not skip_c_unlabeled)
        c.update(noise())
        return {"d": d, "g": noise(), "c": c}

    def triple_iter(self, z_dim: int, num_classes: int, skip_c_unlabeled: bool = False):
        while True:
            yield self.next_triple(z_dim, num_classes, skip_c_unlabeled)

    def test_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        """The test set in order, in batches of one shape: the last one is
        padded with copies of the last image and label, and ``mask`` marks
        the real rows (1.0) from the padding (0.0)."""
        b = self.batch_size
        x, y = self.data.x_test, self.data.y_test
        for start in range(0, len(x), b):
            xe, ye = x[start:start + b], y[start:start + b]
            valid = len(xe)
            if valid < b:
                pad = b - valid
                xe = np.concatenate([xe, np.repeat(xe[-1:], pad, axis=0)])
                ye = np.concatenate([ye, np.repeat(ye[-1:], pad, axis=0)])
            mask = np.zeros((b,), np.float32)
            mask[:valid] = 1.0
            yield {"x": xe, "y": ye, "mask": mask}


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _leaves(tree):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


class _PinnedSlot:
    """One set of pinned host buffers shaped like a batch, and the event
    recorded after the copies that last read them."""

    def __init__(self, batch):
        self.bufs = _tree_map(lambda a: torch.empty(a.shape, dtype=torch.from_numpy(a[:0]).dtype,
                                                    pin_memory=True), batch)
        self.done: Optional[torch.cuda.Event] = None

    def fill(self, batch):
        if self.done is not None:
            self.done.synchronize()  # the copies that read these buffers have run
        for buf, a in zip(_leaves(self.bufs), _leaves(batch)):
            buf.copy_(torch.from_numpy(np.ascontiguousarray(a)))


def device_prefetch(iterator: Iterator[Dict], device, depth: int = 2) -> Iterator[Dict]:
    """The batches of ``iterator`` (nested dicts of numpy arrays) as tensors
    on ``device``, up to ``depth`` of them staged ahead of the consumer, so
    that the host→device copies overlap the step that is running.

    On the card each batch is copied into one of ``depth + 1`` sets of
    pinned host buffers (a set is refilled only after the event recorded
    behind its last copies has passed), then to the card with
    ``non_blocking=True`` on a side stream; before a batch is yielded the
    consumer's stream waits on the event recorded after its copies, and
    each tensor is recorded as used on the consumer's stream, so the
    caching allocator does not hand its memory to a later batch while the
    step still reads it. ``device="cpu"`` yields the batches as CPU
    tensors: the caller asked for the CPU."""
    dev = torch.device(device)
    if dev.type == "cpu":
        for batch in iterator:
            yield _tree_map(torch.from_numpy, batch)
        return
    if dev.type != "cuda":
        raise ValueError(f"device_prefetch takes a cpu or cuda device, got {device!r}")
    copy_stream = torch.cuda.Stream(device=dev)
    slots, staged = [], collections.deque()
    for i, batch in enumerate(iterator):
        if len(slots) < depth + 1:
            slots.append(_PinnedSlot(batch))
        slot = slots[i % (depth + 1)]
        slot.fill(batch)
        with torch.cuda.stream(copy_stream):
            on_dev = _tree_map(lambda t: t.to(dev, non_blocking=True), slot.bufs)
            ready = torch.cuda.Event()
            ready.record(copy_stream)
        slot.done = ready
        staged.append((on_dev, ready))
        if len(staged) >= depth:
            yield _hand_over(*staged.popleft(), dev)
    while staged:
        yield _hand_over(*staged.popleft(), dev)


def _hand_over(on_dev, ready, dev):
    consumer = torch.cuda.current_stream(dev)
    consumer.wait_event(ready)
    for t in _leaves(on_dev):
        t.record_stream(consumer)
    return on_dev
