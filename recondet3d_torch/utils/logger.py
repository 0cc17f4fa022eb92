"""Logger (port of ``recondet3d/utils/logger.py``; reference:
depth_anything_3/utils/logger.py)."""

import logging
import sys

_CONFIGURED = set()


def get_logger(name: str = "recondet3d_torch", level=logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if name not in _CONFIGURED:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter("[%(levelname)s %(asctime)s %(name)s] %(message)s", "%H:%M:%S")
        )
        logger.addHandler(handler)
        logger.setLevel(level)
        logger.propagate = False
        _CONFIGURED.add(name)
    return logger
