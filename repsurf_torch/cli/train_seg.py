"""Segmentation training CLI: the port's counterpart of tools/train_seg.py
(segmentation/tool/train.py).

  python -m repsurf_torch.cli.train_seg --data_dir ./data/S3DIS/trainval_fullarea \\
      --model repsurf.repsurf_umb_ssg --batch_size 8 --epoch 100 \\
      --freeze_epoch 10 --color_contrast --color_shift --color_jitter --hs_shift

Each epoch sets the learning rate and the freeze flag, trains on batches
padded to ``--voxel_max`` points (one step shape on the card), logs the
train counters, validates every ``--val_freq`` epochs once ``epoch + 1 >
--min_val``, logs the per-class IoU and writes the scalars
(``scalars.jsonl``) under ``<log_root>/S3DIS/<log_dir>/logs``.  A better
validation mIoU saves ``checkpoints/best.pt`` there (model with its BN
buffers, optimizer, epoch, best mIoU).  ``--resume`` restores all four
from such a checkpoint (a file, or the directory holding ``best.pt``);
``--pretrain`` restores the weights alone.

``--synthetic`` trains on ``SyntheticRooms`` (no dataset needed);
``cli/test_s3dis --synthetic`` then serves its val rooms from the best
checkpoint.  Every epoch's shuffle and draws come from generators derived
from (seed, epoch), so a resumed run trains as an unbroken one (the JAX
CLI draws from one host ``RandomState`` in sequence).  Not ported, and
refused: ``--n_devices`` and ``--bn`` other than ``global`` (data
parallelism), ``--workers`` (prefetch processes), ``--dataset ScanNet``.
"""

import argparse
import dataclasses
import json
import os
import statistics

import numpy as np
import torch

from ..models import SEG_MODELS


def parse_args(argv=None):
    p = argparse.ArgumentParser("RepSurf segmentation (PyTorch)")
    p.add_argument("--log_dir", type=str, default=None)
    p.add_argument("--log_root", type=str, default="./log")
    p.add_argument("--data_dir", type=str, default="./data/S3DIS/trainval_fullarea")
    p.add_argument("--dataset", type=str, default="S3DIS")
    p.add_argument("--model", default="repsurf.repsurf_umb_ssg",
                   help="one of " + ", ".join(SEG_MODELS))
    p.add_argument("--seed", type=int, default=2000)
    p.add_argument("--epoch", default=100, type=int)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--batch_size_val", type=int, default=8)
    p.add_argument("--optimizer", type=str, default="AdamW")
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight_decay", type=float, default=1e-2)
    p.add_argument("--learning_rate", default=0.006, type=float)
    p.add_argument("--lr_decay", type=float, default=0.1)
    p.add_argument("--lr_decay_epochs", type=int, default=[60, 80], nargs="+")
    p.add_argument("--data_norm", type=str, default="mean")
    p.add_argument("--min_val", type=int, default=60)
    p.add_argument("--val_freq", type=int, default=1)
    p.add_argument("--test_area", type=int, default=5)
    p.add_argument("--voxel_max", type=int, default=80000)
    p.add_argument("--voxel_size", type=float, default=0.04)
    p.add_argument("--loop", type=int, default=30)
    p.add_argument("--aug_scale", action="store_true", default=False)
    p.add_argument("--aug_rotate", type=str, default=None)
    p.add_argument("--aug_jitter", action="store_true", default=False)
    p.add_argument("--aug_flip", action="store_true", default=False)
    p.add_argument("--aug_shift", action="store_true", default=False)
    p.add_argument("--color_contrast", action="store_true", default=False)
    p.add_argument("--color_shift", action="store_true", default=False)
    p.add_argument("--color_jitter", action="store_true", default=False)
    p.add_argument("--hs_shift", action="store_true", default=False)
    p.add_argument("--color_drop", action="store_true", default=False)
    p.add_argument("--group_size", type=int, default=8)
    p.add_argument("--return_polar", action="store_true", default=False)
    p.add_argument("--freeze_epoch", default=int(1e6), type=int)
    p.add_argument("--n_devices", type=int, default=None,
                   help="not ported: data parallelism")
    p.add_argument("--bn", type=str, default="global",
                   help="only global (one device, batch statistics over the batch)")
    p.add_argument("--workers", type=int, default=0,
                   help="not ported: prefetch worker processes")
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint (file or its directory) to resume model, optimizer, "
                        "epoch and best mIoU from")
    p.add_argument("--pretrain", type=str, default=None,
                   help="checkpoint (file or its directory) to load the weights alone from")
    p.add_argument("--synthetic", action="store_true", default=False,
                   help="train on labeled synthetic rooms (no dataset needed)")
    p.add_argument("--synthetic_rooms", type=int, default=12)
    p.add_argument("--synthetic_raw", type=int, default=120000,
                   help="raw points per synthetic room (pre-voxelization)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (cuda, cuda:1, cpu)")
    args = p.parse_args(argv)
    refused = {
        "--n_devices": args.n_devices is not None,
        "--bn": args.bn != "global",
        "--workers": args.workers != 0,
        "--dataset": args.dataset != "S3DIS",
    }
    for flag, given in refused.items():
        if given:
            p.error(f"{flag}: not ported (the port trains S3DIS on one device, in process)")
    return args


@dataclasses.dataclass
class SegRun:
    """What ``main`` leaves: the model and optimizer as the last epoch left
    them, the best validation mIoU, and each trained epoch's mean loss
    {epoch (1-based): loss}."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    best_iou: float
    losses: dict


def _checkpoint_file(path):
    path = os.path.abspath(path)
    return os.path.join(path, "best.pt") if os.path.isdir(path) else path


def main(argv=None):
    args = parse_args(argv)
    from ..config import S3DIS_AUG_ARGS
    from ..data.aug import coord_transform_from_flags, rgb_transform_from_flags
    from ..data.s3dis import CLASS_WEIGHTS, S3DISDataset, pad_batch
    from ..data.synthetic_scene import SyntheticRooms
    from ..nn.metrics import iou_from_counts
    from ..train.checkpoint import BestCheckpointer, apply_train_state, train_state_dict
    from ..train.optim import set_lr
    from ..train.train_seg import (
        SegConfig,
        build_model,
        epoch_lr,
        eval_step,
        is_frozen,
        make_optimizer,
        train_step,
    )
    from ..utils import ScalarWriter, StepTimer, derive_seed, epoch_generator, get_logger, set_seed
    from ..ops.kernels import kernel_launches

    cfg = SegConfig(
        model=args.model, dataset=args.dataset, test_area=args.test_area,
        batch_size=args.batch_size, batch_size_val=args.batch_size_val, epoch=args.epoch,
        optimizer=args.optimizer, learning_rate=args.learning_rate,
        weight_decay=args.weight_decay, momentum=args.momentum, lr_decay=args.lr_decay,
        lr_decay_epochs=tuple(args.lr_decay_epochs), min_val=args.min_val,
        val_freq=args.val_freq, freeze_epoch=args.freeze_epoch, seed=args.seed,
        voxel_size=args.voxel_size, voxel_max=args.voxel_max, data_norm=args.data_norm,
        loop=args.loop, group_size=args.group_size, return_polar=args.return_polar,
        aug_scale=args.aug_scale, aug_rotate=args.aug_rotate, aug_jitter=args.aug_jitter,
        aug_flip=args.aug_flip, aug_shift=args.aug_shift, color_contrast=args.color_contrast,
        color_shift=args.color_shift, color_jitter=args.color_jitter, hs_shift=args.hs_shift,
        color_drop=args.color_drop,
    )
    if cfg.data_norm != "mean":
        raise ValueError(f"--data_norm {cfg.data_norm}: the S3DIS pipeline mean-centres")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device here (use --device cpu)")

    exp = os.path.join(args.log_root, cfg.dataset, args.log_dir or "default")
    log_dir = os.path.join(exp, "logs")
    logger = get_logger(log_dir, "train_seg")
    logger.info(cfg)

    init_gen = set_seed(cfg.seed)
    coord_t = coord_transform_from_flags(cfg, S3DIS_AUG_ARGS)
    rgb_t = rgb_transform_from_flags(cfg)
    if args.synthetic:
        train_set = SyntheticRooms(
            "train", n_rooms=args.synthetic_rooms, raw_points=args.synthetic_raw,
            loop=cfg.loop, voxel_size=cfg.voxel_size, voxel_max=cfg.voxel_max,
            coord_transform=coord_t, rgb_transform=rgb_t, shuffle_index=True, seed=cfg.seed)
        val_set = SyntheticRooms(
            "val", n_rooms=max(2, args.synthetic_rooms // 4), raw_points=args.synthetic_raw,
            loop=1, voxel_size=cfg.voxel_size, voxel_max=cfg.voxel_max, seed=cfg.seed)
    else:
        train_set = S3DISDataset(
            args.data_dir, "train", test_area=cfg.test_area, loop=cfg.loop,
            voxel_size=cfg.voxel_size, voxel_max=cfg.voxel_max, coord_transform=coord_t,
            rgb_transform=rgb_t, shuffle_index=True)
        val_set = S3DISDataset(
            args.data_dir, "val", test_area=cfg.test_area, loop=cfg.loop,
            voxel_size=cfg.voxel_size, voxel_max=cfg.voxel_max)
    logger.info(f"train rooms={len(train_set.rooms)} val rooms={len(val_set.rooms)}")

    model = build_model(cfg, generator=init_gen).to(device)
    opt = make_optimizer(model, cfg)
    logger.info(f"{cfg.model}: {sum(p.numel() for p in model.parameters())} parameters on "
                f"{device}")
    class_weight = torch.tensor(CLASS_WEIGHTS[cfg.test_area], dtype=torch.float32,
                                device=device)
    ckpt = BestCheckpointer(os.path.join(exp, "checkpoints"))
    best_iou, start_epoch = 0.0, 0
    if args.resume or args.pretrain:
        path = _checkpoint_file(args.resume or args.pretrain)
        restored = torch.load(path, map_location=device, weights_only=True)
        start_epoch, best_iou = apply_train_state(model, opt, restored,
                                                  weights_only=args.pretrain is not None)
        ckpt.best_metric = best_iou
        logger.info(f"restored from {path} (epoch {start_epoch}, best {best_iou:.4f})")

    def batches(ds, bs, rng, shuffle):
        order = np.arange(len(ds))
        if shuffle:
            rng.shuffle(order)
        for s in range(0, len(order) - bs + 1, bs):
            samples = [ds.get(int(i), rng=rng) for i in order[s:s + bs]]
            batch = pad_batch(samples, cfg.voxel_max, cfg.ignore_label)
            yield {k: torch.from_numpy(v).to(device) for k, v in batch.items()}

    def counts(parts):
        return np.stack([p.cpu().numpy() for p in parts]).astype(np.float64)

    losses = {}
    with ScalarWriter(log_dir) as writer:
        for epoch in range(start_epoch, cfg.epoch):
            set_lr(opt, epoch_lr(cfg, epoch))
            freeze = is_frozen(cfg, epoch)
            gen = epoch_generator(cfg.seed, epoch, device)
            rng = np.random.RandomState(derive_seed(cfg.seed, epoch) % 2**32)
            timer = StepTimer()
            tot = np.zeros((3, cfg.num_class))
            step_losses, step_s = [], []
            for i, batch in enumerate(batches(train_set, cfg.batch_size, rng, True)):
                timer.data_loaded()
                loss, parts = train_step(model, opt, batch, class_weight, cfg, generator=gen,
                                         freeze=freeze)
                step_losses.append(float(loss))  # synchronises
                tot += counts(parts)
                timer.step_done()
                step_s.append(timer.batch.val - timer.data.val)
                if (i + 1) % 50 == 0:
                    logger.info(f"epoch {epoch + 1} [{i + 1}] loss {np.mean(step_losses):.4f} "
                                f"batch {timer.batch.avg:.3f}s")
            if not step_losses:
                raise ValueError(f"no training batch: {len(train_set)} samples, batch "
                                 f"{cfg.batch_size}")
            loss = float(np.mean(step_losses))
            losses[epoch + 1] = loss
            miou, macc, allacc = (float(x) for x in iou_from_counts(*torch.from_numpy(tot)))
            logger.info(
                f"train epoch {epoch + 1}/{cfg.epoch}: loss {loss:.6f} mIoU/mAcc/OA "
                f"{miou * 100:.2f}/{macc * 100:.2f}/{allacc * 100:.2f} lr {epoch_lr(cfg, epoch):g}"
                f"{' frozen' if freeze else ''}; {len(step_losses)} steps, step median "
                f"{statistics.median(step_s):.4f} s, data {timer.data.avg:.4f} s")
            writer.add_scalar("loss_train", loss, epoch + 1)
            writer.add_scalar("mIoU_train", miou, epoch + 1)
            writer.add_scalar("mAcc_train", macc, epoch + 1)
            writer.add_scalar("allAcc_train", allacc, epoch + 1)

            if epoch + 1 > cfg.min_val and (epoch + 1) % cfg.val_freq == 0:
                tot = np.zeros((3, cfg.num_class))
                vlosses = []
                vrng = np.random.RandomState(derive_seed(cfg.seed, epoch, 1) % 2**32)
                for batch in batches(val_set, cfg.batch_size_val, vrng, False):
                    vloss, _, parts = eval_step(model, batch, class_weight, cfg)
                    vlosses.append(float(vloss))
                    tot += counts(parts)
                miou, macc, allacc = (float(x) for x in iou_from_counts(*torch.from_numpy(tot)))
                logger.info(f"val epoch {epoch + 1}: mIoU/mAcc/OA {miou * 100:.2f}/"
                            f"{macc * 100:.2f}/{allacc * 100:.2f} loss {np.mean(vlosses):.4f}")
                iou_class = tot[0] / (tot[1] + 1e-10)
                acc_class = tot[0] / (tot[2] + 1e-10)
                for ci in range(cfg.num_class):
                    logger.info(f"class_{ci}: IoU/Acc {iou_class[ci] * 100:.2f}/"
                                f"{acc_class[ci] * 100:.2f}")
                    writer.add_scalar(f"class_{ci}_val_iou", iou_class[ci], epoch + 1)
                writer.add_scalar("loss_val", float(np.mean(vlosses)), epoch + 1)
                writer.add_scalar("mIoU_val", miou, epoch + 1)
                writer.add_scalar("mAcc_val", macc, epoch + 1)
                writer.add_scalar("allAcc_val", allacc, epoch + 1)
                if miou > best_iou:
                    best_iou = miou
                    ckpt.maybe_save(best_iou, epoch + 1,
                                    train_state_dict(model, opt, epoch + 1, best_iou))
                    logger.info(f"best mIoU -> {best_iou * 100:.2f} (epoch {epoch + 1} saved)")
    logger.info(f"done; best mIoU {best_iou * 100:.2f}")
    logger.info(f"kernel launches {json.dumps(kernel_launches())}")
    return SegRun(model, opt, best_iou, losses)


if __name__ == "__main__":
    main()
