"""A file + stdout logger, running meters, a step timer, a profiler trace
context and a JSONL scalar writer (repsurf_tpu/utils/logging.py
``get_logger``, ``AverageMeter``, ``StepTimer``, ``profile_trace``,
``ScalarWriter``)."""

import contextlib
import json
import logging
import os
import sys
import time

import torch


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


class AverageMeter:
    """Running value/avg/sum/count meter."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0
        self.avg = 0
        self.sum = 0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


class StepTimer:
    """Batch and data wall-clock times and the remaining-time ETA (the
    reference's inline meters, segmentation/tool/train.py:262-267,309-318).
    ``batch.val`` is the last step's seconds, data loading included."""

    def __init__(self):
        self.batch = AverageMeter()
        self.data = AverageMeter()
        self._end = time.time()

    def data_loaded(self):
        self.data.update(time.time() - self._end)

    def step_done(self):
        self.batch.update(time.time() - self._end)
        self._end = time.time()

    def eta(self, remaining_steps):
        secs = int(remaining_steps * self.batch.avg)
        m, s = divmod(secs, 60)
        h, m = divmod(m, 60)
        return f"{h:02d}:{m:02d}:{s:02d}"


@contextlib.contextmanager
def profile_trace(log_dir, enabled=True):
    """``torch.profiler`` over the block (host, and the card's kernels when
    CUDA is available), written as a Chrome trace
    ``<log_dir>/trace_<pid>.json`` (chrome://tracing, Perfetto); yields
    the profiler, or None when not ``enabled``."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))


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
