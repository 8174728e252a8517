"""Whole-scene S3DIS evaluation CLI: the port's counterpart of
tools/test_s3dis.py (segmentation/tool/test_s3dis.py): multi-pass voxel
cover, potential-field chunking, vote accumulation, the optional kNN median
filter and visualisation dumps.

  python -m repsurf_torch.cli.test_s3dis --data_dir ./data/S3DIS/trainval_fullarea \\
      --test_area 5 --log_dir repsurf_umb --filter

``--synthetic`` evaluates the raw labeled rooms of ``SyntheticRooms``
instead of the room files.  The weights come from ``--model_path``, else
from ``<log_root>/S3DIS/<log_dir>/checkpoints/best.pt`` when it exists (the
model's state alone, out of the trainer's full payload); without either the
model keeps its seeded random initialisation.  ``--model_path`` also takes
a reference ``.pth`` (``train/torch_import.py``), told apart from the
port's payload by its keys.  ``--device`` defaults to the
card and raises without one.  ``--profile`` writes a ``torch.profiler``
Chrome trace of the first scene (``utils.profile_trace``) into the log
directory: the scene's host stages (the port's ``scene.*`` spans) beside
the operators and kernels they issue.
"""

import argparse
import json
import os

import numpy as np
import torch

from ..models import SEG_MODELS, SEG_RECIPES


def parse_args(argv=None):
    p = argparse.ArgumentParser("RepSurf S3DIS test (PyTorch)")
    p.add_argument("--log_dir", type=str, default=None)
    p.add_argument("--data_dir", type=str, default="./data/S3DIS/trainval_fullarea")
    p.add_argument("--log_root", type=str, default="./log")
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--model", default="repsurf.repsurf_umb_ssg",
                   help="one of " + ", ".join(SEG_MODELS))
    p.add_argument("--seed", type=int, default=1000)
    p.add_argument("--batch_size_test", type=int, default=4)
    p.add_argument("--test_area", type=int, default=5)
    p.add_argument("--filter", action="store_true", default=False)
    p.add_argument("--data_norm", type=str, default="mean")
    p.add_argument("--visual", action="store_true", default=False)
    p.add_argument("--group_size", type=int, default=8)
    p.add_argument("--return_polar", action="store_true", default=False)
    p.add_argument("--voxel_max", type=int, default=80000)
    p.add_argument("--voxel_size", type=float, default=0.04)
    p.add_argument("--synthetic", action="store_true", default=False,
                   help="evaluate on labeled synthetic rooms (no dataset)")
    p.add_argument("--synthetic_rooms", type=int, default=3)
    p.add_argument("--synthetic_raw", type=int, default=120000)
    p.add_argument("--synthetic_seed", type=int, default=2000,
                   help="the trainer's --seed, so the val rooms are the same universe")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to evaluate on (cuda, cuda:1, cpu)")
    p.add_argument("--profile", action="store_true", default=False,
                   help="write a Chrome trace of the first scene into the log directory")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..data.synthetic_scene import SyntheticRooms
    from ..nn.metrics import intersection_and_union, iou_from_counts
    from ..ops.kernels import kernel_launches
    from ..train.checkpoint import restore_weights
    from ..train.torch_import import restore_any_weights
    from ..train.eval_s3dis import (
        LABEL2CLASS,
        device_batches,
        median_filter,
        predict_scene,
        visualize_scene,
    )
    from ..train.train_seg import SegConfig, build_model
    from ..utils import get_logger, profile_trace

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device here (use --device cpu)")
    cfg = SegConfig(model=args.model, group_size=args.group_size,
                    return_polar=args.return_polar, **SEG_RECIPES.get(args.model, {}))
    exp = os.path.join(args.log_root, "S3DIS", args.log_dir or "default")
    log_dir = os.path.join(exp, "logs")
    logger = get_logger(log_dir, "test_s3dis")
    logger.info(cfg)

    model = build_model(cfg, generator=torch.Generator().manual_seed(cfg.seed))
    ckpt = args.model_path or os.path.join(exp, "checkpoints", "best.pt")
    if args.model_path is not None:
        kind = restore_any_weights(model, ckpt)
        logger.info(f"checkpoint restored from {ckpt} ({kind} format)")
    elif os.path.exists(ckpt):
        restore_weights(model, ckpt)
        logger.info(f"checkpoint restored from {ckpt}")
    else:
        logger.warning("no checkpoint found - evaluating random init")
    model = model.to(device).eval()

    def forward_fn(batch):
        with torch.no_grad():
            return model(batch["coord"], batch["feat"], batch["valid"])

    if args.synthetic:
        synth = SyntheticRooms("val", n_rooms=args.synthetic_rooms,
                               raw_points=args.synthetic_raw, seed=args.synthetic_seed)
        names = list(synth.rooms)

        def load_scene(si, name):
            return synth.raw(si)
    else:
        names = sorted(f[:-4] for f in os.listdir(args.data_dir)
                       if f.endswith(".npy") and f"Area_{args.test_area}" in f)

        def load_scene(si, name):
            return np.load(os.path.join(args.data_dir, name + ".npy"))

    logger.info(f"{len(names)} scenes")
    tot = torch.zeros((3, cfg.num_class), dtype=torch.float64)
    for si, name in enumerate(names):
        data = load_scene(si, name)
        coord, feat, label = data[:, :3], data[:, 3:6], data[:, 6]
        profiled = args.profile and si == 0
        with profile_trace(log_dir, enabled=profiled):
            pred = predict_scene(forward_fn, coord, feat, cfg.num_class,
                                 voxel_size=args.voxel_size, voxel_max=args.voxel_max,
                                 batch_size=args.batch_size_test, data_norm=args.data_norm,
                                 seed=args.seed, device=device)
            if args.filter:
                pred = median_filter(coord.astype(np.float32), pred, 32, device=device)
        if profiled:
            logger.info(f"profiler trace of scene 1 written to {log_dir}")
        counts = intersection_and_union(torch.from_numpy(pred),
                                        torch.from_numpy(label.astype(np.int64)),
                                        cfg.num_class, cfg.ignore_label)
        tot += torch.stack(counts).double()
        logger.info(f"scene {si + 1}/{len(names)} {name}: {label.size} pts")
        if args.visual:
            visualize_scene(os.path.join(exp, "visual"), name, coord, pred, label)

    miou, macc, allacc = (float(x) for x in iou_from_counts(*tot))
    logger.info(f"result: mIoU/mAcc/OA {miou * 100:.2f}/{macc * 100:.2f}/{allacc * 100:.2f}")
    iou_class = tot[0] / (tot[1] + 1e-10)
    acc_class = tot[0] / (tot[2] + 1e-10)
    for i in range(cfg.num_class):
        logger.info(f"class {i} ({LABEL2CLASS[i]}): IoU/Acc "
                    f"{float(iou_class[i]) * 100:.2f}/{float(acc_class[i]) * 100:.2f}")
    logger.info(f"kernel launches {json.dumps(kernel_launches())}")
    logger.info(f"crops by where they were cut {json.dumps(dict(device_batches.crops))}")
    return miou, macc, allacc


if __name__ == "__main__":
    main()
