"""Guard diagnostics of the window kNN kernel at the four window call sites
of the segmentation step: the port's counterpart of
tools/knn_window_stats.py.

    python -m repsurf_torch.cli.knn_window_stats [--points 80000] [--device cuda]

On bench.py's two rooms (``common.seg_batch``) and their FPS subsets (N/4,
then N/16), it prints, per call, the queries of each sample that the
window pass could not vouch for and the re-solve pass took again
(``knn_window.resolved``), and the call's seconds.  The port's guard has
one reason: a query's k-th distance does not clear the gap to the nearest
inner face of its 3 x 3 x 3 block of cells (with the slack for the float32
rounding of the cell assignment; ``csrc/knn_window.cu``).  The JAX tool's
three columns (``kth>margin``, ``overflow``, ``overhang``) belong to its
own kernel's guard, which also bounds a DMA window; the port's kernel
reads the cells in place and has no such budget.  On the CPU
(``--device cpu``) the plain version runs and no guard exists, so nothing
is counted.
"""

import argparse
import time

import torch

from .common import resolve_device, seg_batch, sync


def parse_args(argv=None):
    p = argparse.ArgumentParser("RepSurf window kNN guard diagnostics (PyTorch)")
    p.add_argument("--points", type=int, default=80000, help="points a room")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda, cuda:1, cpu); the card by default")
    return p.parse_args(argv)


def call_sites(xyz):
    """The seg step's four window calls: (label, k, points, queries)."""
    from ..ops.gather import index_points
    from ..ops.sampling import farthest_point_sample

    n = xyz.shape[1]
    q4 = index_points(xyz, farthest_point_sample(xyz, n // 4))
    q16 = index_points(q4, farthest_point_sample(q4, n // 16))
    m4, m16 = q4.shape[1], q16.shape[1]
    return [(f"umbrella k=9 {n}->{n}", 9, xyz, xyz),
            (f"sa1 k=32 {n}->{m4}", 32, xyz, q4),
            (f"sa2 k=32 {m4}->{m16}", 32, q4, q16),
            (f"fp1 k=3 {m4}->{n}", 3, q4, xyz)]


def main(argv=None):
    """Returns [(label, re-solved queries per sample, or None on the CPU)]."""
    args = parse_args(argv)
    from ..ops.kernels.knn_window import knn_window

    dev = resolve_device(args.device)
    xyz = torch.from_numpy(seg_batch(args.points, 2)["coord"]).to(dev)
    print(f"device={dev} batch {xyz.shape[0]} x {xyz.shape[1]} points")
    t0 = time.perf_counter()
    sites = call_sites(xyz)
    sync(dev)
    print(f"fps subsets {time.perf_counter() - t0:.3f} s")
    out = []
    for label, k, pts, qs in sites:
        t0 = time.perf_counter()
        knn_window(k, pts, qs)
        sync(dev)
        dt = time.perf_counter() - t0
        resolved = knn_window.resolved.tolist() if dev.type == "cuda" else None
        counts = "not counted (the plain version on the CPU has no guard)" if resolved is None \
            else f"re-solved queries per sample {resolved}"
        print(f"{label:26s} {counts} of {qs.shape[1]}   [{dt:.3f} s, first call included]")
        out.append((label, resolved))
    return out


if __name__ == "__main__":
    main()
