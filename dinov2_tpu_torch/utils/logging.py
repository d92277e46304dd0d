"""The port's logger (its own copy of dinov2_tpu/utils/logging.py's):
messages go to stderr as "dinov2_tpu_torch: <message>", and the model-load
banner keeps the reference's field names (dinov2.cpp's printf banner) so
logs of both packages compare line by line."""

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


def log_model_banner(config, path: str) -> None:
    log = get_logger()
    log.info("loading model from '%s'", path)
    log.info("hidden_size            = %d", config.hidden_size)
    log.info("num_hidden_layers      = %d", config.num_hidden_layers)
    log.info("num_register_tokens    = %d", config.num_register_tokens)
    log.info("num_attention_heads    = %d", config.num_attention_heads)
    log.info("patch_size             = %d", config.patch_size)
    log.info("img_size               = %d", config.img_size)
    log.info("ftype                  = %d", config.ftype)
