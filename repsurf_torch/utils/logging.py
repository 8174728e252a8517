"""A file + stdout logger and a JSONL scalar writer
(repsurf_tpu/utils/logging.py ``get_logger``, ``ScalarWriter``)."""

import json
import logging
import os
import sys


def get_logger(log_dir, name="repsurf_torch"):
    """Logger writing to ``<log_dir>/<name>.txt`` and to stdout, in the
    reference's format; its handlers are replaced on every call."""
    os.makedirs(log_dir, exist_ok=True)
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    for h in logger.handlers:
        h.close()
    logger.handlers = []
    fmt = logging.Formatter("[%(asctime)s %(levelname)s %(filename)s:%(lineno)d] %(message)s")
    fh = logging.FileHandler(os.path.join(log_dir, f"{name}.txt"))
    fh.setFormatter(fmt)
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(fh)
    logger.addHandler(sh)
    return logger


class ScalarWriter:
    """Scalars as JSON lines in ``<log_dir>/scalars.jsonl``:
    {"tag", "value", "step"} per line, appended and flushed each time."""

    def __init__(self, log_dir):
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "scalars.jsonl"), "a")

    def add_scalar(self, tag, value, step):
        self._f.write(json.dumps({"tag": tag, "value": float(value), "step": int(step)}) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
