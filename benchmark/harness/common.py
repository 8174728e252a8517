"""What every run shares: the specification read from BENCHMARK.json and
the files it names, the seeds, the card's identity and the import check."""

import dataclasses
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "repsurf_tpu")


@dataclasses.dataclass
class Spec:
    """One cell as BENCHMARK.json and its files define it."""

    name: str
    chips: int
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<mix>.json: "kind" and its parameters
    cell: dict  # workloads/<cell>.json: trace span and the limits of `correct`
    end_to_end: list  # the cell's end-to-end metric entries
    per_layer: list  # the cell's per-layer metric entries


def _applies(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def load_spec(cell):
    root = json.loads((REPO / "BENCHMARK.json").read_text())
    entry = next((w for w in root["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise SystemExit(f"no workload {cell!r} in BENCHMARK.json")
    conf = next(c for c in root["configs"] if c["name"] == entry["config"])
    return Spec(
        name=cell, chips=entry["chips"],
        config=json.loads((REPO / conf["file"]).read_text()),
        traffic=json.loads((BENCH / "traffic" / f"{entry['traffic']}.json").read_text()),
        cell=json.loads((BENCH / "workloads" / f"{cell}.json").read_text()),
        end_to_end=[m for m in root["end_to_end"] if _applies(m, cell)],
        per_layer=[m for m in root["per_layer"] if _applies(m, cell)],
    )


@dataclasses.dataclass(frozen=True)
class Seeds:
    """Independent streams drawn from the run's --seed: the inputs, the
    weights, the training steps' draws, the sample the check takes."""

    data: int
    weights: int
    steps: int
    sample: int

    @classmethod
    def of(cls, seed):
        words = np.random.SeedSequence(int(seed)).generate_state(4)
        return cls(*(int(w) for w in words))


def load_module(path, name):
    """Import a file of the benchmark by its path (names hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def named(package, dotted):
    """The function a configuration names under ``package`` of the
    benchmark: ``"models.seg_forward"`` is ``seg_forward`` of
    ``benchmark/<package>/models.py``."""
    module, _, attr = dotted.rpartition(".")
    return getattr(importlib.import_module(f"benchmark.{package}.{module}"), attr)


def reference_model(config):
    """(plan, forward) of the plain reference the configuration names."""
    ref = config["reference"]
    return named("reference", ref["plan"]), named("reference", ref["forward"])


def forbidden_loaded():
    """Top-level names in sys.modules that a run may not load, compared as
    whole names ('repsurf_torch' is not 'repsurf_tpu')."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def card_fields(index=0):
    """{"device": name, "power_limit": limit} as nvidia-smi gives them (a
    frozen copy of the program's ``bench.card_fields``)."""
    smi = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    name, limit = (s.strip() for s in smi.rsplit(",", 1))
    return {"device": name, "power_limit": limit}


def card_state(index=0):
    """Clocks, power, temperature and memory of the card, one line of
    nvidia-smi, or the reason it could not be read."""
    try:
        return subprocess.run(
            ["nvidia-smi", f"--id={index}",
             "--query-gpu=name,power.limit,power.draw,clocks.sm,clocks.mem,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"
