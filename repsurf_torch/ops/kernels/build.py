"""Build and load the CUDA kernels of ``repsurf_torch/csrc``.

nvcc compiles every ``csrc/*.cu`` to an object, one process per source, all
started together, and links them into one shared library with a plain C
interface, which ``ctypes`` loads.  The build runs at first use, into
``build/kernels/`` at the repository root, and is keyed by a hash of the
sources, headers and flags, so an edited source is rebuilt and an unchanged
one is loaded as it is.  Nothing here runs when the module is imported.

``-fmad=false`` keeps nvcc from contracting ``a*b + c`` into one FMA: the
kernels' distance sums must round op by op, as their plain versions do,
or ties and radius boundaries flip.  Each source compiles with ``-Xptxas
-v``, and its report (registers, stack, spills per kernel) is kept beside
the library; ``resources`` reads it.
"""

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double
# name -> (restype, argtypes); every pointer and the stream are c_void_p
_SIGNATURES = {
    "repsurf_fps": (_I, [_P, _P, _I, _I, _I, _P, _P, _P, _P]),
    "repsurf_fps_register_points": (_I, []),
    "repsurf_fps_block_points": (_I, []),
    "repsurf_fps_cluster_size": (_I, [_I]),
    "repsurf_fps_round_floor": (_I, [_P, _I, _I, _I, _P, _P]),
    "repsurf_umbrella_tq": (_I, [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P]),
    "repsurf_umbrella_tq_scan_floor": (_I, [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P]),
    "repsurf_umbrella_full": (_I, [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P]),
    "repsurf_umbrella_full_warps": (_I, [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P]),
    "repsurf_umbrella_slab": (
        _I,
        [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    ),
    "repsurf_umbrella_slab_resolve": (
        _I,
        [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _I, _P, _P],
    ),
    "repsurf_ball_feature": (
        _I,
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P, _P, _P, _P],
    ),
    "repsurf_ball_feature_max_nsample": (_I, []),
    "repsurf_ball_group": (
        _I,
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P, _P, _P],
    ),
    "repsurf_ball_group_select_floor": (
        _I,
        [_P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P, _P],
    ),
    "repsurf_ball_scatter": (_I, [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P]),
    "repsurf_ball_scatter_scratch": (ctypes.c_longlong, [_I, _I, _I]),
    "repsurf_knn": (_I, [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P]),
    "repsurf_knn_max_k": (_I, []),
    "repsurf_knn_window": (
        _I,
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    ),
    "repsurf_knn_window_resolve": (
        _I,
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    ),
    "repsurf_knn_window_max_k": (_I, []),
    "repsurf_chunk_mean": (_I, [_P, _P, _I, _I, _I, _I, _P, _P]),
    "repsurf_bn_scratch_bytes": (_L, [_L, _I, _I, _I, _I]),
    "repsurf_bn_stats": (
        _I,
        [_P, _P, _L, _I, _L, _L, _I, _D, _D, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    ),
    "repsurf_bn_normalize": (_I, [_P, _L, _I, _I, _P, _P, _I, _D, _P, _P, _I, _P, _P]),
    "repsurf_bn_backward": (
        _I,
        [_P, _P, _P, _L, _I, _L, _I, _P, _P, _I, _D, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _P],
    ),
}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path():
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librepsurf_kernels_{h.hexdigest()[:16]}.so"


def report_path():
    """Where the ptxas report of the current library's build lives."""
    return library_path().with_suffix(".ptxas.txt")


def resources(report):
    """{mangled kernel name: (registers, stack bytes, spill store bytes,
    spill load bytes)} from a ``-Xptxas -v`` report."""
    out, name = {}, None
    stack = (0, 0, 0)
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
        used = re.search(r"Used (\d+) registers", line)
        if entry:
            name, stack = entry.group(1), (0, 0, 0)
        elif frame:
            stack = tuple(int(g) for g in frame.groups())
        elif used and name:
            out[name] = (int(used.group(1)), *stack)
            name = None
    return out


def build():
    """Compile the sources unless the library for them exists.

    Returns (path, seconds spent compiling; 0.0 when it was already built).
    """
    path = library_path()
    if path.exists():
        return path, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [Path(work) / f"{src.stem}.o" for src in _sources()]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(_sources(), objs)
        ]
        failed, reports = [], []
        for src, proc in zip(_sources(), procs):
            out, _ = proc.communicate()
            reports.append(out)
            if proc.returncode != 0:
                failed.append(f"{src.name} ({proc.returncode}):\n{out}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        report_path().write_text("\n".join(reports))
        tmp = Path(work) / path.name
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}{link.stderr}")
        os.replace(tmp, path)  # atomic: a reader never sees half a library
    return path, time.perf_counter() - t0


@functools.lru_cache(maxsize=1)
def library():
    """The loaded kernel library (built first if needed), argtypes set."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib

