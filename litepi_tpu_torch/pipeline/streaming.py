"""Streaming inference: decode ahead on the host, dispatch ahead on the card.

Three stages overlap, as in the JAX package's ``StreamingRunner``:

1. a host thread decodes and letterboxes batches (the native loader when
   it builds, cv2 otherwise) and stages each in a ring of pinned host
   buffers (the native loader decodes straight into them);
2. the main thread copies a staged batch to the card on a copy stream
   (``non_blocking``), makes the compute stream wait for that copy only,
   dispatches ``run_fused`` and at once queues non-blocking copies of its
   outputs into pinned host buffers, behind an event;
3. up to ``inflight`` dispatched batches ride the card's queue; the oldest
   is finished when the window is full by waiting on its own event, never
   on the batches queued after it (a plain ``.cpu()`` on the compute
   stream would wait for all of them).

A pinned buffer is written again only after the copy that read it has
completed.  On a CPU pipeline there is no pinning and no stream: batches
run one after another, which is the CPU path the caller asked for.

The JAX package's ``server=`` option (multi-chip ``MeshServer``) is not
ported here.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from litepi_tpu_torch.core.device import resolve_device
from litepi_tpu_torch.pipeline.two_stage import TwoStagePipeline

Outputs = Dict[str, np.ndarray]


def _cv2_load_batch(paths: Sequence[str], out_size: int) -> np.ndarray:
    """Host loader without the native library: cv2 decode at the original
    resolution (frames of one batch must share it); unreadable frames
    become grey frames of the batch's resolution."""
    import cv2

    frames = [cv2.imread(p) for p in paths]
    ref_shape = next((f.shape for f in frames if f is not None), (out_size, out_size, 3))
    return np.stack([f if f is not None else np.full(ref_shape, 114, np.uint8) for f in frames])


def area_scale_of(geoms: np.ndarray) -> np.ndarray:
    """Per-frame ``1 / ratio^2`` of loader geoms rows (ratio, dw, dh,
    orig_w, orig_h): box areas on a letterboxed canvas times this are areas
    in original pixels, so the min-area floor stays in original pixels."""
    return 1.0 / np.maximum(geoms[:, 0], 1e-9) ** 2


def unmap_boxes(boxes: np.ndarray, geoms: np.ndarray) -> np.ndarray:
    """Canvas-space boxes (N, D, 4) -> original pixels of each frame,
    clipped to it, from loader geoms rows (N, 5)."""
    r = np.maximum(geoms[:, 0:1, None], 1e-9)
    shift = geoms[:, None, [1, 2, 1, 2]]
    limit = np.stack([geoms[:, 3], geoms[:, 4], geoms[:, 3], geoms[:, 4]], axis=-1)
    return np.clip((boxes - shift) / r, 0.0, limit[:, None, :])


class _PinnedSlot:
    """Pinned host buffers of one staged batch (frames, area_scale) and the
    event recorded after the copy to the card that last read them."""

    def __init__(self) -> None:
        self.frames: Optional[torch.Tensor] = None
        self.area: Optional[torch.Tensor] = None
        self.copied: Optional[torch.cuda.Event] = None

    def acquire(self) -> None:
        """Wait until the last copy out of these buffers has completed."""
        if self.copied is not None:
            self.copied.synchronize()
            self.copied = None

    def frames_view(self, shape) -> np.ndarray:
        if self.frames is None or tuple(self.frames.shape) != tuple(shape):
            self.frames = torch.empty(tuple(shape), dtype=torch.uint8, pin_memory=True)
        return self.frames.numpy()

    def stage(self, frames: np.ndarray, area: Optional[np.ndarray]) -> None:
        view = self.frames_view(frames.shape)
        if frames is not view:
            np.copyto(view, frames)
        if area is None:
            self.area = None
            return
        if self.area is None or self.area.shape[0] != area.shape[0]:
            self.area = torch.empty(area.shape[0], dtype=torch.float32, pin_memory=True)
        self.area.numpy()[:] = area


class _Pending:
    """A dispatched batch: its outputs (pinned host copies on the card, the
    outputs themselves on the CPU) and the event after their copy."""

    def __init__(self, outputs: Dict[str, torch.Tensor], ready=None) -> None:
        self.outputs = outputs
        self.ready = ready

    def result(self, real: int, geoms: Optional[np.ndarray]) -> Outputs:
        if self.ready is not None:
            self.ready.synchronize()  # this batch only
        host = {k: v.numpy()[:real] for k, v in self.outputs.items()}
        if geoms is not None:
            # pre-letterboxed canvases: boxes come back in canvas space
            host["boxes"] = unmap_boxes(host["boxes"], geoms[:real])
        return host


class StreamingRunner:
    """Decode-ahead, dispatch-ahead streaming executor over a
    :class:`TwoStagePipeline`, on the pipeline's device."""

    def __init__(
        self,
        pipe: TwoStagePipeline,
        batch_size: int = 64,
        inflight: int = 2,
        prefetch_depth: int = 4,
        decode_threads: int = 8,
        use_native_loader: Optional[bool] = None,
        scaled_decode: bool = True,
    ) -> None:
        """``scaled_decode`` (native loader only): libjpeg's DCT-domain
        scaled decode at the smallest fast scale covering the letterbox
        target, a throughput option whose pixels differ slightly from a
        full decode (box geometry does not change)."""
        self.pipe = pipe
        self.device = resolve_device(pipe.device)
        self.batch_size = batch_size
        self.inflight = inflight
        self.prefetch_depth = prefetch_depth
        self.scaled_decode = scaled_decode
        self._native = None
        if use_native_loader is not False:
            from litepi_tpu_torch.data import native_loader

            if native_loader.available():
                self._native = native_loader.NativeBatchLoader(
                    threads=decode_threads,
                    out_size=pipe.cfg.det_input_size,
                    scaled_decode=scaled_decode,
                )
            elif use_native_loader:
                raise RuntimeError(
                    f"native loader requested but unavailable: {native_loader.build_error()}"
                )
        self._cuda = self.device.type == "cuda"
        self._copy_stream = torch.cuda.Stream(self.device) if self._cuda else None
        # a batch's slot is written again prefetch_depth + 2 batches later:
        # by then the main thread has taken the batch from the queue and
        # issued its copy (the producer waits for that copy to complete)
        self._slots = [_PinnedSlot() for _ in range(prefetch_depth + 2)] if self._cuda else []

    # ------------------------------------------------------------------ #

    def _decode_batch(
        self, paths: Sequence[str], out: Optional[np.ndarray] = None
    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """(frames, geoms): pre-letterboxed canvases and their geoms rows
        from the native loader (decoded into ``out`` when given), else
        original-resolution frames from cv2 and None."""
        if self._native is not None:
            return self._native.load(list(paths), out)
        return _cv2_load_batch(paths, self.pipe.cfg.det_input_size), None

    def _load(self, paths: Sequence[str], slot: Optional[_PinnedSlot]):
        """Decode one batch; on the card, stage it in ``slot``.  Returns
        (frames or None, area_scale or None, geoms or None)."""
        out = None
        if slot is not None:
            slot.acquire()
            if self._native is not None:
                s = self.pipe.cfg.det_input_size
                out = slot.frames_view((len(paths), s, s, 3))
        frames, geoms = self._decode_batch(paths, out)
        area = None if geoms is None else area_scale_of(geoms)
        if slot is None:
            return frames, area, geoms
        slot.stage(frames, area)
        return None, None, geoms

    def _upload(self, slot: _PinnedSlot):
        """Copy a staged batch to the card on the copy stream; the compute
        stream waits for that copy only.  Returns (frames, area_scale) on
        the card."""
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            frames = slot.frames.to(self.device, non_blocking=True)
            area = None if slot.area is None else slot.area.to(self.device, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self._copy_stream)
        slot.copied = copied
        compute.wait_event(copied)
        # the copy stream allocated them: keep the allocator from handing
        # their memory out again before the compute stream is done with it
        for t in (frames, area):
            if t is not None:
                t.record_stream(compute)
        return frames, area

    @torch.inference_mode()
    def _dispatch(self, frames, conf_threshold, area) -> _Pending:
        out = self.pipe.run_fused(frames, conf_threshold, area_scale=area)
        if not self._cuda:
            return _Pending(out)
        host = {}
        for k, v in out.items():
            host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            host[k].copy_(v, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        return _Pending(host, ready)

    def run(
        self,
        paths: Sequence[str],
        conf_threshold: Optional[float] = None,
    ) -> Iterator[Tuple[List[str], Outputs]]:
        """Stream results for ``paths`` in submission order.

        Yields (batch_paths, outputs as numpy) per batch with only the real
        entries: the trailing batch is padded by repeating its last path,
        and the padding is stripped, so ``len(batch_paths)`` is the leading
        dim of every array and no path appears twice.  With the native
        loader, boxes are unmapped from the canvas to original pixels.
        """
        bs = self.batch_size
        batches = [list(paths[i : i + bs]) for i in range(0, len(paths), bs)]
        trailing_real = bs
        if batches and len(batches[-1]) < bs:
            trailing_real = len(batches[-1])
            batches[-1] += [batches[-1][-1]] * (bs - len(batches[-1]))

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_depth)
        sentinel, stop = object(), threading.Event()

        def producer() -> None:
            try:
                for i, b in enumerate(batches):
                    if stop.is_set():
                        return
                    real = trailing_real if i == len(batches) - 1 else bs
                    slot = self._slots[i % len(self._slots)] if self._cuda else None
                    q.put((b[:real], slot, *self._load(b, slot)))
            except Exception as e:  # raised again on the consuming thread
                q.put(e)
            finally:
                q.put(sentinel)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        window: List[Tuple[List[str], _Pending, Optional[np.ndarray]]] = []
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, Exception):
                    raise item
                batch_paths, slot, frames, area, geoms = item
                if slot is not None:
                    frames, area = self._upload(slot)
                window.append((batch_paths, self._dispatch(frames, conf_threshold, area), geoms))
                if len(window) > self.inflight:
                    done_paths, pending, done_geoms = window.pop(0)
                    yield done_paths, pending.result(len(done_paths), done_geoms)
            for done_paths, pending, done_geoms in window:
                yield done_paths, pending.result(len(done_paths), done_geoms)
        finally:
            stop.set()
            while thread.is_alive():  # free a producer blocked on a full queue
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass

    # ------------------------------------------------------------------ #

    def benchmark(
        self,
        paths: Sequence[str],
        conf_threshold: Optional[float] = None,
        warmup_batches: int = 1,
    ) -> Dict[str, float]:
        """Sustained end-to-end throughput, decode and transfer included."""
        for _ in self.run(list(paths[: self.batch_size * warmup_batches]), conf_threshold):
            pass
        t0 = time.perf_counter()
        n = sum(len(batch_paths) for batch_paths, _ in self.run(paths, conf_threshold))
        dt = time.perf_counter() - t0
        return {
            "frames": n,
            "seconds": dt,
            "fps": n / dt if dt > 0 else 0.0,
            "native_decoder": self._native is not None,
        }

    def benchmark_ram(
        self,
        frames: np.ndarray,
        n_batches: int = 20,
        conf_threshold: Optional[float] = None,
        warmup_batches: int = 2,
    ) -> Dict[str, float]:
        """Transfer-inclusive, decode-exclusive throughput: one batch of
        decoded frames from RAM, staged once, then copied to the card and
        run through the same dispatch-ahead window as :meth:`run`
        ``n_batches`` times; a batch is finished by waiting on its own
        output copy."""
        bs = self.batch_size
        if frames.shape[0] < bs:
            raise ValueError(f"need >= {bs} frames, got {frames.shape[0]}")
        batch = np.ascontiguousarray(frames[:bs])
        slot = None
        if self._cuda:
            slot = _PinnedSlot()
            slot.stage(batch, None)

        def dispatch() -> _Pending:
            f = self._upload(slot)[0] if slot is not None else batch
            return self._dispatch(f, conf_threshold, None)

        for _ in range(warmup_batches):
            dispatch().result(bs, None)
        window: List[_Pending] = []
        t0 = time.perf_counter()
        for _ in range(n_batches):
            window.append(dispatch())
            if len(window) > self.inflight:
                window.pop(0).result(bs, None)
        for pending in window:
            pending.result(bs, None)
        dt = time.perf_counter() - t0
        return {
            "frames": n_batches * bs,
            "seconds": dt,
            "fps": n_batches * bs / dt if dt > 0 else 0.0,
        }

    def decode_probe(
        self,
        paths: Sequence[str],
        threads: int = 1,
        scaled_decode: Optional[bool] = None,
    ) -> Dict[str, float]:
        """Host JPEG-decode throughput (frames/s at ``threads`` decode
        threads) through the loader the streaming path uses; the cv2 path
        decodes on one thread whatever ``threads`` asks, and says so."""
        loader = None
        if self._native is not None:
            from litepi_tpu_torch.data.native_loader import NativeBatchLoader

            loader = NativeBatchLoader(
                threads=threads,
                out_size=self.pipe.cfg.det_input_size,
                scaled_decode=self.scaled_decode if scaled_decode is None else scaled_decode,
            )
        try:
            t0 = time.perf_counter()
            if loader is not None:
                loader.load(list(paths))
            else:
                _cv2_load_batch(paths, self.pipe.cfg.det_input_size)
            dt = time.perf_counter() - t0
        finally:
            if loader is not None:
                loader.close()
        return {
            "frames": len(paths),
            "seconds": dt,
            "fps": len(paths) / dt if dt > 0 else 0.0,
            "threads": threads if loader is not None else 1,
        }

    def close(self) -> None:
        if self._native is not None:
            self._native.close()
            self._native = None
