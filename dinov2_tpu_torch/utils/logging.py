"""The port's logger (its own copy of dinov2_tpu/utils/logging.py's):
messages go to stderr as "dinov2_tpu_torch: <message>"."""

from __future__ import annotations

import logging
import sys

_LOGGER = logging.getLogger("dinov2_tpu_torch")
if not _LOGGER.handlers:
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter("%(name)s: %(message)s"))
    _LOGGER.addHandler(handler)
    _LOGGER.setLevel(logging.INFO)


def get_logger() -> logging.Logger:
    return _LOGGER
