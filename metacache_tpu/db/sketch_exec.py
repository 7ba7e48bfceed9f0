"""Batched device execution of the sketcher for database builds.

Windows stream through fixed-size device batches (static shapes, one XLA
compilation) — the counterpart of the reference GPU's double-buffered
sequence_batch insert pipeline (src/gpu_hashmap.cu:190-230).

The accumulator batches windows ACROSS targets so small targets share
device dispatches (the reference likewise packs many targets into one
sequence_batch, src/sequence_batch.cuh:132-195). On an accelerator one
dispatch shape is used throughout: every new shape is a new compilation,
which costs more than sketching a padded batch; on the CPU, where the
padding is the larger cost, the final partial batch pads only to the
next power of two.
"""
from __future__ import annotations

import collections

import numpy as np

from ..ops.windows import PAD_CODE

_BATCH = 65536  # windows per device dispatch


def _pad_size(n: int) -> int:
    """Dispatch shape for a partial batch of n windows."""
    import jax
    if jax.devices()[0].platform == "cpu":
        p = 256
        while p < n:
            p *= 2
        return min(p, _BATCH)
    return _BATCH


def _device_sketcher(w: int, k: int, sketchlen: int):
    """Sketch callable for (n, w) window batches (the XLA sketcher)."""
    from ..ops.sketch_jax import sketch_windows
    return lambda wj, vj: sketch_windows(wj, vj, k=k, sketchlen=sketchlen)


def sketch_windows_batched(wm: np.ndarray, vl: np.ndarray,
                           k: int, sketchlen: int) -> np.ndarray:
    import jax.numpy as jnp

    n, w = wm.shape
    sketcher = _device_sketcher(w, k, sketchlen)
    out = np.empty((n, sketchlen),
                   dtype=np.uint32 if k <= 16 else np.uint64)
    for beg in range(0, n, _BATCH):
        end = min(beg + _BATCH, n)
        cur = end - beg
        if cur < _BATCH:
            size = _pad_size(cur)
            wpad = np.full((size, w), PAD_CODE, np.uint8)
            wpad[:cur] = wm[beg:end]
            vpad = np.zeros(size, np.int32)
            vpad[:cur] = vl[beg:end]
            res = sketcher(jnp.asarray(wpad), jnp.asarray(vpad))
            out[beg:end] = np.asarray(res)[:cur]
        else:
            res = sketcher(jnp.asarray(wm[beg:end]),
                           jnp.asarray(vl[beg:end]))
            out[beg:end] = np.asarray(res)
    return out


class SketchAccumulator:
    """Accumulates per-target window matrices and sketches them in large
    cross-target device batches.

    Appended targets are processed in queue order, so the emitted
    (feature, location) stream stays ascending in (tgt, win) — the
    invariant FeatureTable.build's presorted fast path relies on.
    """

    def __init__(self, k: int, sketchlen: int, batch: int = _BATCH):
        self.k = k
        self.sketchlen = sketchlen
        self.batch = batch
        # queue of (windows, valid, target_id, first_window_id)
        self._q: collections.deque = collections.deque()
        self._nwin = 0
        self.features: list[np.ndarray] = []   # u32 chunks
        self.locations: list[np.ndarray] = []  # u64 chunks

    def add_target(self, wm: np.ndarray, vl: np.ndarray, tid: int):
        """Queue one target's window matrix (nw, winlen)."""
        if len(wm) == 0:
            return
        self._q.append((wm, vl, tid, 0))
        self._nwin += len(wm)
        while self._nwin >= self.batch:
            self._flush(self.batch)

    def _flush(self, nw: int):
        """Sketch exactly nw queued windows (nw <= self._nwin)."""
        take = []
        left = nw
        while left:
            wm, vl, tid, win0 = self._q.popleft()
            if len(wm) <= left:
                take.append((wm, vl, tid, win0))
                left -= len(wm)
            else:
                take.append((wm[:left], vl[:left], tid, win0))
                self._q.appendleft((wm[left:], vl[left:], tid, win0 + left))
                left = 0
        self._nwin -= nw
        self._sketch_and_emit(take)

    def _sketch_and_emit(self, take):
        from ..ops.table import pack_locations
        wm = np.concatenate([t[0] for t in take], axis=0)
        vl = np.concatenate([t[1] for t in take])
        feats = sketch_windows_batched(wm, vl, self.k, self.sketchlen)
        beg = 0
        for m, _v, tid, win0 in take:
            cnt = len(m)
            f = feats[beg:beg + cnt]
            beg += cnt
            wid = np.broadcast_to(
                (win0 + np.arange(cnt, dtype=np.uint32))[:, None], f.shape)
            mask = f != f.dtype.type(np.iinfo(f.dtype).max)
            self.features.append(f[mask])
            self.locations.append(pack_locations(
                np.full(int(mask.sum()), tid, np.uint32), wid[mask]))

    def finish(self):
        """Sketch remaining windows; -> (features u32, locations u64)."""
        if self._nwin:
            self._flush(self._nwin)
        if self.features:
            f = np.concatenate(self.features)
            l = np.concatenate(self.locations)
        else:
            f = np.zeros(0, np.uint32 if self.k <= 16 else np.uint64)
            l = np.zeros(0, np.uint64)
        self.features, self.locations = [], []
        return f, l


class DeviceSketchAccumulator:
    """SketchAccumulator variant whose (feature, tgt, win) stream stays
    ON DEVICE — feeds ops.table_device.build_device_table so RefSeq-scale
    builds never round-trip sketches or probe layouts through the host
    (the reference's GPU insert pipeline keeps locations device-resident
    the same way, src/gpu_hashmap.cu:190-230).

    Sentinel feature slots (empty sketch lanes, padding windows) are NOT
    masked here — masking would make shapes dynamic; they sort last in
    build_device_table and are dropped there.
    """

    def __init__(self, k: int, sketchlen: int, batch: int = _BATCH):
        self.k = k
        self.sketchlen = sketchlen
        self.batch = batch
        self._q: collections.deque = collections.deque()
        self._nwin = 0
        self.chunks: list = []      # device (f, t, w) flats per dispatch

    def add_target(self, wm: np.ndarray, vl: np.ndarray, tid: int):
        if len(wm) == 0:
            return
        self._q.append((wm, vl, tid, 0))
        self._nwin += len(wm)
        while self._nwin >= self.batch:
            self._flush(self.batch)

    def _flush(self, nw: int):
        take = []
        left = nw
        while left:
            wm, vl, tid, win0 = self._q.popleft()
            if len(wm) <= left:
                take.append((wm, vl, tid, win0))
                left -= len(wm)
            else:
                take.append((wm[:left], vl[:left], tid, win0))
                self._q.appendleft((wm[left:], vl[left:], tid,
                                    win0 + left))
                left = 0
        self._nwin -= nw
        self._sketch_and_emit_device(take)

    def _sketch_and_emit_device(self, take):
        import jax.numpy as jnp
        wm = np.concatenate([t[0] for t in take], axis=0)
        vl = np.concatenate([t[1] for t in take])
        tid = np.concatenate([
            np.full(len(m), t_, np.int32) for (m, _v, t_, _w0) in take])
        wid = np.concatenate([
            w0 + np.arange(len(m), dtype=np.int32)
            for (m, _v, _t, w0) in take])
        n, w = wm.shape
        sketcher = _device_sketcher(w, self.k, self.sketchlen)
        for beg in range(0, n, _BATCH):
            end = min(beg + _BATCH, n)
            cur = end - beg
            size = _pad_size(cur) if cur < _BATCH else _BATCH
            if cur < size:
                wpad = np.full((size, w), PAD_CODE, np.uint8)
                wpad[:cur] = wm[beg:end]
                vpad = np.zeros(size, np.int32)
                vpad[:cur] = vl[beg:end]
                tpad = np.zeros(size, np.int32)
                tpad[:cur] = tid[beg:end]
                wipad = np.zeros(size, np.int32)
                wipad[:cur] = wid[beg:end]
            else:
                wpad, vpad = wm[beg:end], vl[beg:end]
                tpad, wipad = tid[beg:end], wid[beg:end]
            f = sketcher(jnp.asarray(wpad), jnp.asarray(vpad))
            s = self.sketchlen
            tdev = jnp.broadcast_to(jnp.asarray(tpad)[:, None],
                                    (size, s)).reshape(-1)
            wdev = jnp.broadcast_to(jnp.asarray(wipad)[:, None],
                                    (size, s)).reshape(-1)
            self.chunks.append((f.reshape(-1), tdev, wdev))

    def finish_chunks(self):
        """-> list of (features u32, tgt i32, win i32) flat device
        chunk triples for ops.table_device.build_device_table_chunked
        (sentinel features included; the build drops them). Never
        concatenates — at RefSeq scale the concatenated stream plus its
        sources would transiently double HBM use."""
        if self._nwin:
            self._flush(self._nwin)
        chunks, self.chunks = self.chunks, []
        return chunks

    def finish_device(self):
        """-> (features u32, tgt i32, win i32) flat device arrays
        (sentinel features included; build_device_table drops them).
        Prefer finish_chunks() at scale — this concatenates."""
        import jax.numpy as jnp
        chunks = self.finish_chunks()
        if not chunks:
            z = jnp.zeros(0, jnp.int32)
            return jnp.zeros(0, jnp.uint32), z, z
        f = jnp.concatenate([c[0] for c in chunks])
        t = jnp.concatenate([c[1] for c in chunks])
        w = jnp.concatenate([c[2] for c in chunks])
        return f, t, w
