"""``card_fields``, the card's name and power limit as a run records them.

It is all that is left of the port's first bench, which ``benchmark/``
replaced: ``benchmark/tests/test_harness_frozen.py`` holds the benchmark's
frozen copy (``benchmark/harness/common.card_fields``) to this one, so the
module goes when that test compares against the frozen copy alone.
"""

import subprocess

import torch


def card_fields(dev):
    """{"device": name, "power_limit": limit} as nvidia-smi gives them for
    a CUDA device; the CPU has no power limit."""
    if dev.type != "cuda":
        return {"device": "cpu", "power_limit": None}
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    smi = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    name, limit = (s.strip() for s in smi.rsplit(",", 1))
    return {"device": name, "power_limit": limit}
