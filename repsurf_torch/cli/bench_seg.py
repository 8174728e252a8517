"""Segmentation train-step throughput on one card: the port's counterpart
of tools/bench_seg.py.

    python -m repsurf_torch.cli.bench_seg [--device cuda]

Runs ``repsurf_torch.bench.bench_seg`` (batch 2 x 80,000 points, bench.py's
rooms) and prints its JSON line under the one name
``s3dis_train_scenes_per_sec_per_chip``; tools/bench_seg.py's name for the
same number, ``s3dis_train_samples_per_sec_per_chip``, is an alias.
"""

import argparse

from ..bench import bench_seg


def main(argv=None):
    p = argparse.ArgumentParser("RepSurf seg train-step bench (PyTorch)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda, cuda:1, cpu); the card by default")
    args = p.parse_args(argv)
    return bench_seg(device=args.device)


if __name__ == "__main__":
    main()
