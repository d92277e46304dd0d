"""Threaded image loading (port of dinov2_tpu/runtime/loader.py): decode on
host threads, prefetch batches through a bounded queue so host decode
overlaps device compute.

Decoding goes through OpenCV (its decoder is native and releases the GIL),
imported where it is first needed, so a machine without `cv2` still imports
this module and runs everything that takes arrays.
"""

from __future__ import annotations

import concurrent.futures
import queue
import threading
from pathlib import Path
from typing import Iterable, Iterator

import numpy as np

IMAGE_EXTENSIONS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


def list_images(root: str | Path) -> list[Path]:
    root = Path(root)
    if root.is_file():
        return [root]
    return sorted(
        p for p in root.rglob("*") if p.suffix.lower() in IMAGE_EXTENSIONS
    )


def decode_rgb(path: str | Path) -> np.ndarray:
    import cv2

    img = cv2.imread(str(path))
    if img is None:
        raise ValueError(f"failed to decode {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


class _ProducerError:
    """Marker carrying a producer-thread exception to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class BatchLoader:
    """Iterates (paths, images) batches with threaded decode and prefetch.

    Images are resized on the host to a common (h, w) so batches are
    rectangular. Two host-resize modes:

      - interpolation="cubic-float" (classification-accurate): float32/255
        first, then cv2.INTER_CUBIC, the reference's preprocessing order
        (dinov2.cpp: convertTo(CV_32FC3, 1/255) before resize). Batches are
        float32 in [0, 1]; the engine's bicubic resize to the same size is
        then the identity.
      - interpolation="nearest" (uint8, like the reference's realtime frame
        resize): cheap; the engine's bicubic does the model-accurate resize
        from this common size.
    """

    def __init__(
        self,
        paths: Iterable[str | Path],
        batch_size: int = 32,
        size: tuple[int, int] | None = (518, 518),
        num_threads: int = 8,
        prefetch: int = 2,
        interpolation: str = "nearest",
    ):
        self.paths = [Path(p) for p in paths]
        self.batch_size = batch_size
        self.size = size
        self.num_threads = num_threads
        self.prefetch = prefetch
        if interpolation not in ("nearest", "cubic-float"):
            raise ValueError(f"unknown interpolation {interpolation!r}")
        self.interpolation = interpolation

    def _decode(self, path: Path) -> np.ndarray:
        import cv2

        img = decode_rgb(path)
        if self.size is None:
            return img
        if self.interpolation == "cubic-float":
            img = img.astype(np.float32) / 255.0
            return cv2.resize(
                img, (self.size[1], self.size[0]), interpolation=cv2.INTER_CUBIC
            )
        return cv2.resize(
            img, (self.size[1], self.size[0]), interpolation=cv2.INTER_NEAREST
        )

    def __len__(self) -> int:
        return (len(self.paths) + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[tuple[list[Path], np.ndarray]]:
        batches = [
            self.paths[i : i + self.batch_size]
            for i in range(0, len(self.paths), self.batch_size)
        ]
        out: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            # the end marker or the error marker must reach the consumer even
            # when a decode raises (a corrupt file), or the consumer blocks
            # forever on out.get()
            try:
                with concurrent.futures.ThreadPoolExecutor(self.num_threads) as pool:
                    for chunk in batches:
                        if stop.is_set():
                            return
                        imgs = list(pool.map(self._decode, chunk))
                        out.put((chunk, np.stack(imgs, axis=0)))
            except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
                out.put(_ProducerError(e))
            else:
                out.put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out.get()
                if item is None:
                    return
                if isinstance(item, _ProducerError):
                    raise item.exc
                yield item
        finally:
            stop.set()
            # unblock a producer stuck on a full queue so its pool can exit
            try:
                while True:
                    out.get_nowait()
            except queue.Empty:
                pass
