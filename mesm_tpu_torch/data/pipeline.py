"""Prefetching input pipeline and the host-to-device feed.

A small thread pool assembles fixed-shape numpy batches ahead of the eval
step (HDF5 + numpy release the GIL for the heavy parts), with bounded
lookahead so host IO overlaps device compute. `device_feed` then stages each
batch onto the device from pinned memory, one batch ahead of the consumer;
`stage_superbatch` stages K batches at once for the coalesced eval step.
"""
from __future__ import annotations

import queue
import threading
from collections import deque
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

_SENTINEL = object()

# Per-WORKER loader (each pool worker process gets its own copy via the pool
# initializer below; nothing is shared through the parent's module state, so
# two process-mode loaders can iterate concurrently).
_worker_loader = None


def _process_worker_init(loader):
    global _worker_loader
    _worker_loader = loader


def _process_worker_build(idx_batch):
    return _worker_loader._build(idx_batch)


class Loader:
    """Batch loader with three worker modes:

    - thread (default): a small thread pool; HDF5 and numpy release the GIL
      for the heavy parts, and per-thread HDF5 handles let reads overlap.
    - process: a fork-based worker pool for hosts where collate's Python
      work (tokenizing, mask assembly) is the bottleneck — the reference
      uses torch DataLoader worker processes the same way (runner.py:88-98).
      Workers never touch the device; FeatureStore re-opens its HDF5 handles
      after the fork (data/hdf5.py pid check). Built batches return to the parent
      via pickle, so feature-heavy batches pay an IPC copy (--loader_mode).
    - anything with num_workers <= 1: synchronous.
    """

    def __init__(
        self,
        dataset,
        batcher,
        collate: Callable,
        num_workers: int = 2,
        prefetch: int = 3,
        mode: str = "thread",
    ):
        self.dataset = dataset
        self.batcher = batcher
        self.collate = collate
        self.num_workers = max(num_workers, 1)
        self.prefetch = max(prefetch, 1)
        self.mode = mode

    def _build(self, idx_batch):
        entries = [self.dataset[i] for i in idx_batch]
        return self.collate(entries)

    def _iter_process(self, batches) -> Iterator:
        import multiprocessing as mp

        # Pool workers never report item visits back to the parent, so
        # per-epoch randomness comes from the dataset's epoch offset instead:
        # the FIRST process-mode epoch pins the offset at 0 (matching thread
        # mode's epoch-0 visit counts, so both modes draw the same
        # augmentation stream), later epochs advance it.
        ds = self.dataset
        if hasattr(ds, "advance_epoch"):
            if getattr(ds, "_epoch_offset", None) is None:
                ds._epoch_offset = 0
            else:
                ds.advance_epoch()

        # forkserver, not fork: the parent holds a live (multithreaded) CUDA
        # runtime, and forking it can deadlock in the child (inherited lock
        # state). The forkserver's children are forked from a clean helper
        # process; the loader reaches each worker by pickle via the pool
        # initializer (dataset/collate implement __getstate__ as needed).
        ctx = mp.get_context("forkserver")
        pool = ctx.Pool(
            self.num_workers, initializer=_process_worker_init, initargs=(self,)
        )
        try:
            # imap preserves batch order; bounded internally by the pool
            for built in pool.imap(_process_worker_build, batches, chunksize=1):
                yield built
        finally:
            pool.terminate()
            pool.join()

    def __iter__(self) -> Iterator:
        batches = list(self.batcher)
        if self.num_workers <= 1:
            for idxs in batches:
                yield self._build(idxs)
            return
        if self.mode == "process":
            yield from self._iter_process(batches)
            return

        in_q: "queue.Queue" = queue.Queue()
        for i, idxs in enumerate(batches):
            in_q.put((i, idxs))
        for _ in range(self.num_workers):
            in_q.put(_SENTINEL)

        results: dict = {}
        errors: list = []
        next_slot = [0]
        cond = threading.Condition()

        def worker():
            while True:
                item = in_q.get()
                if item is _SENTINEL:
                    with cond:
                        cond.notify_all()
                    return
                slot, idxs = item
                try:
                    built = self._build(idxs)
                except Exception as e:
                    with cond:
                        errors.append(e)
                        cond.notify_all()
                    return
                with cond:
                    # bounded lookahead: don't run too far ahead of the consumer
                    while slot > next_slot[0] + self.prefetch and not errors:
                        cond.wait(timeout=10)
                    results[slot] = built
                    cond.notify_all()

        threads = [
            threading.Thread(target=worker, daemon=True) for _ in range(self.num_workers)
        ]
        for t in threads:
            t.start()

        for produced in range(len(batches)):
            with cond:
                while next_slot[0] not in results:
                    if errors:
                        raise errors[0]
                    if not any(t.is_alive() for t in threads):
                        raise RuntimeError("loader workers exited early")
                    cond.wait(timeout=10)
                built = results.pop(next_slot[0])
                next_slot[0] += 1
                cond.notify_all()
            yield built

    def __len__(self) -> int:
        return len(self.batcher)


def stage_batch(batch, cast_bf16: bool, device) -> Dict[str, torch.Tensor]:
    """Host batch -> device tensors. float32 fields of ndim >= 3 (the video
    and cached word features) are cast to bf16 on the host first when
    `cast_bf16`; every other field keeps its dtype. CUDA copies go through
    pinned memory and are issued non-blocking on the current stream. A
    multi-clip (QVHighlights) batch's per-group SS video is expanded to its
    rows on the device by `ss_group_slot` (mesm_tpu/data/pipeline.py:179-182)."""
    device = torch.device(device)
    pin = device.type == "cuda"
    jb = {}
    for k, v in batch.items():
        a = np.asarray(v)
        t = torch.from_numpy(np.ascontiguousarray(a))
        if cast_bf16 and a.dtype == np.float32 and a.ndim >= 3:
            t = t.to(torch.bfloat16)
        if pin:
            t = t.pin_memory().to(device, non_blocking=True)
        jb[k] = t
    if "ss_video_feat_groups" in jb:
        slot = jb.pop("ss_group_slot").long()
        jb["ss_video_feat"] = jb.pop("ss_video_feat_groups")[slot]
        jb["ss_video_mask"] = jb.pop("ss_video_mask_groups")[slot]
    return jb


def staged_signature(fields: Dict[str, torch.Tensor]) -> tuple:
    """The shape signature of staged tensors: sorted (name, shape, dtype)."""
    return tuple(sorted((k, tuple(v.shape), v.dtype) for k, v in fields.items()))


def stage_superbatch(batches, cast_bf16: bool, device,
                     into: Optional[Callable[[tuple], Optional[Dict[str, torch.Tensor]]]] = None
                     ) -> Dict[str, torch.Tensor]:
    """K same-shape host batches -> ONE staged batch whose tensors carry a
    leading K axis (mesm_tpu/data/pipeline.py:239-300), the argument of
    make_eval_step(coalesce=K).

    Per field: one stack into host memory (pinned for CUDA), with the bf16
    cast of the float32 fields of ndim >= 3 per batch folded into it (the
    rule of stage_batch), then one host-to-device copy. The unique videos
    `video_feat_g` (K, NG, Lv, Dv) are staged as the contiguous 2-D
    `video_feat_rows` (K * NG * Lv, Dv) that the hoisted projection reads.
    The row-major pinning of the JAX version (_put_rows_rowmajor) is a TPU
    layout fix with no counterpart here. A multi-clip (QVHighlights)
    superbatch's per-group SS video is expanded to its rows by one batched
    gather on the device.

    `into(signature)`, when given (CoalescedEvalStep.static_inputs), names
    tensors of the staged signature to write into (a CUDA graph's static
    inputs) or None; the fields go there instead of into new tensors."""
    device = torch.device(device)
    pin = device.type == "cuda"
    K = len(batches)
    host = {}
    for k in batches[0]:
        parts = [torch.from_numpy(np.ascontiguousarray(np.asarray(b[k]))) for b in batches]
        dt = parts[0].dtype
        if cast_bf16 and dt == torch.float32 and parts[0].dim() >= 3:
            dt = torch.bfloat16
        buf = torch.empty((K,) + tuple(parts[0].shape), dtype=dt, pin_memory=pin)
        for i, part in enumerate(parts):
            if part.shape != parts[0].shape:
                raise ValueError(f"stage_superbatch: {k} has shapes {tuple(parts[0].shape)} and "
                                 f"{tuple(part.shape)}; a superbatch takes batches of one shape")
            buf[i].copy_(part)
        host[k] = buf
    if "video_feat_g" in host:
        vf = host.pop("video_feat_g")
        host["video_feat_rows"] = vf.view(-1, vf.shape[-1])
    ss = "ss_video_feat_groups" in host
    fields = {k: (tuple(v.shape), v.dtype) for k, v in host.items()}
    if ss:
        rows = fields.pop("ss_group_slot")[0]  # (K, B)
        for src, name in _SS_FIELDS:
            shape, dt = fields.pop(src)
            fields[name] = (rows + shape[2:], dt)
    dst = into(tuple(sorted((k, shape, dt) for k, (shape, dt) in fields.items()))) if into else None
    staged = {}
    for k, t in host.items():
        if dst is not None and k in dst:
            staged[k] = dst[k].copy_(t, non_blocking=pin)
        else:
            staged[k] = t.to(device, non_blocking=pin)
    if ss:
        slot = staged.pop("ss_group_slot").long()
        lead = torch.arange(K, device=device)[:, None]
        for src, name in _SS_FIELDS:
            expanded = staged.pop(src)[lead, slot]
            staged[name] = expanded if dst is None else dst[name].copy_(expanded)
    return staged


_SS_FIELDS = (("ss_video_feat_groups", "ss_video_feat"), ("ss_video_mask_groups", "ss_video_mask"))


def device_feed(loader, device, cast_bf16: bool, depth: int = 2):
    """Yields (jb, batch, meta) with `jb` staged `depth - 1` batches ahead, so
    the copy of batch N+1 is queued while the step on batch N runs; `batch`
    keeps the host arrays for decoding."""
    buf: deque = deque()
    for batch, meta in loader:
        buf.append((stage_batch(batch, cast_bf16, device), batch, meta))
        if len(buf) >= depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()
