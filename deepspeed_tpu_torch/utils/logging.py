"""The port's logger (a copy of ``deepspeed_tpu/utils/logging.py``'s, which
the port may not import: that package pulls in JAX). It writes to stderr so
that stdout stays free for a script's results."""
from __future__ import annotations

import logging
import os
import sys

LOG_FORMAT = "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s"


def _create_logger(name: str = "deepspeed_tpu_torch") -> logging.Logger:
    level = getattr(logging, os.environ.get("DSTPU_LOG_LEVEL", "INFO").upper(), logging.INFO)
    lg = logging.getLogger(name)
    lg.setLevel(level)
    lg.propagate = False
    if not lg.handlers:
        handler = logging.StreamHandler(stream=sys.stderr)
        handler.setFormatter(logging.Formatter(LOG_FORMAT))
        lg.addHandler(handler)
    return lg


logger = _create_logger()
