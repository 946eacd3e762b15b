"""Colored console + per-run file logger (the reference's `utils.py:56-81`); a
copy of `llama3_quantization_tpu/utils/logger.py`."""

from __future__ import annotations

import functools
import logging
import os
import sys
import time
from typing import Optional


@functools.lru_cache()
def create_logger(
    output_dir: Optional[str] = None, dist_rank: int = 0, name: str = "l3q"
) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False

    fmt = "[%(asctime)s %(name)s] (%(filename)s %(lineno)d): %(levelname)s %(message)s"
    color_fmt = (
        "\x1b[32m[%(asctime)s %(name)s]\x1b[0m"
        "\x1b[33m(%(filename)s %(lineno)d)\x1b[0m: %(levelname)s %(message)s"
    )

    if dist_rank == 0:
        console = logging.StreamHandler(sys.stdout)
        console.setLevel(logging.DEBUG)
        console.setFormatter(logging.Formatter(fmt=color_fmt, datefmt="%Y-%m-%d %H:%M:%S"))
        logger.addHandler(console)

    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        fh = logging.FileHandler(
            os.path.join(output_dir, f"log_rank{dist_rank}_{int(time.time())}.txt"),
            mode="a",
        )
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(logging.Formatter(fmt=fmt, datefmt="%Y-%m-%d %H:%M:%S"))
        logger.addHandler(fh)
    return logger
