"""Directory serving pipeline (mirror of ``runtime/serving.py``): native
threaded decode -> device -> encode pool.

The serial ``SuperResolver.upscale_dir`` runs imread -> upscale -> imwrite
one image after another.  Here the three stages overlap:

  * a decode thread keeps a bounded lookahead queue filled through the
    native codec's batch loader (``runtime/native_io.imread_batch``: C
    threads, the GIL released), or through ``data/io.imread`` (PIL, the
    numpy codecs) where the library is absent or a file is not its format;
  * the main thread runs ``resolver.upscale``, the device's only caller;
  * a thread pool encodes (the native encode releases the GIL too), with at
    most ``2 * encode_threads`` outputs pending.

A file that decodes by no codec is skipped with a warning; the decode thread
always ends the queue, so the consumer never waits forever.  The outputs
are the serial loop's, under the same names.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

from image_enhance_keras_tpu_torch.data.io import imread, imwrite, list_images
from image_enhance_keras_tpu_torch.engine import output_name
from image_enhance_keras_tpu_torch.utils.logging import get_logger

__all__ = ["PipelineStats", "serve_directory"]

log = get_logger(__name__)


@dataclasses.dataclass
class PipelineStats:
    images: int
    out_pixels: int
    wall_s: float
    decode_s: float  # decode thread's busy time
    device_s: float  # main thread's upscale time (upload, compute, download)
    encode_s: float  # encoders' busy time, summed

    @property
    def out_mpix_s(self) -> float:
        return self.out_pixels / max(self.wall_s, 1e-9) / 1e6


def _decode_worker(paths, q, batch, threads, busy):
    from image_enhance_keras_tpu_torch.runtime import native_io

    def _fallback(p):
        try:
            return imread(p)  # PIL or the numpy codecs, for what the native codec does not read
        except Exception as e:  # noqa: BLE001 - a bad file must not stop the pipeline
            log.warning("skipping undecodable %s (%s)", p, e)
            return None

    try:
        for i in range(0, len(paths), batch):
            chunk = paths[i : i + batch]
            t0 = time.perf_counter()
            if native_io.available():
                imgs = native_io.imread_batch(chunk, threads=threads)
            else:
                imgs = [_fallback(p) for p in chunk]
            busy[0] += time.perf_counter() - t0
            for p, im in zip(chunk, imgs):
                if im is None and native_io.available():
                    im = _fallback(p)
                if im is not None:
                    q.put((p, im))
    finally:
        q.put(None)  # the consumer must never wait forever


def serve_directory(
    resolver,
    dir_path: str,
    suffix: str = "scaled",
    scale_label: int = 1,
    decode_threads: int = 8,
    encode_threads: int = 4,
    lookahead: int = 4,
) -> PipelineStats:
    """Upscale every image of a directory with overlapped IO; returns the stats."""
    tag = f"_{suffix}("
    paths = [
        p for p in list_images(dir_path)
        if tag not in os.path.basename(p) and "_intermediate_" not in os.path.basename(p)
    ]
    q: queue.Queue = queue.Queue(maxsize=lookahead)
    decode_busy = [0.0]
    t_start = time.perf_counter()
    # a decode batch of at least the thread count, else native threads idle
    # while the batch drains; the queue's bound alone caps memory
    dec = threading.Thread(
        target=_decode_worker,
        args=(paths, q, max(lookahead, decode_threads), decode_threads, decode_busy),
        daemon=True,
    )
    dec.start()

    device_s = 0.0
    encode_busy = [0.0]
    lock = threading.Lock()
    out_px = 0
    n = 0

    def _encode(dst, arr):
        t0 = time.perf_counter()
        imwrite(dst, arr)
        with lock:
            encode_busy[0] += time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=encode_threads) as pool:
        futures: deque = deque()
        # backpressure: each pending encode holds a whole x4 uint8 output;
        # when the device outruns the encoders, wait on the oldest
        max_pending = 2 * encode_threads
        while True:
            item = q.get()
            if item is None:
                break
            path, img = item
            t0 = time.perf_counter()
            out = resolver.upscale(img)
            device_s += time.perf_counter() - t0
            out_px += out.shape[0] * out.shape[1]
            n += 1
            futures.append(pool.submit(_encode, output_name(path, suffix, scale_label), out))
            while len(futures) >= max_pending:
                futures.popleft().result()
        for f in futures:
            f.result()
    dec.join()
    wall = time.perf_counter() - t_start
    stats = PipelineStats(n, out_px, wall, decode_busy[0], device_s, encode_busy[0])
    log.info(
        "served %d images: %.2f out-Mpix/s wall (device %.2fs, decode %.2fs, encode %.2fs)",
        n, stats.out_mpix_s, device_s, decode_busy[0], encode_busy[0],
    )
    return stats
