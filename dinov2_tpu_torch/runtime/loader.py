"""Image files to RGB arrays (the port's own copy of what it needs from
dinov2_tpu/runtime/loader.py; `list_images` and the threaded BatchLoader
are not ported).

Decoding goes through OpenCV, imported where it is first needed, so a
machine without `cv2` still imports this module and runs everything that
takes arrays.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

IMAGE_EXTENSIONS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


def decode_rgb(path: str | Path) -> np.ndarray:
    import cv2

    img = cv2.imread(str(path))
    if img is None:
        raise ValueError(f"failed to decode {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
