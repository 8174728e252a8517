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
checkpoint.  ``--dataset ScanNet`` reads ``scene*.npy`` files
(``data/scannet.py``); its constants (21 classes, ignore label 0, voxel
0.02, ``voxel_max`` 120,000, loop 6) replace the S3DIS defaults of the flags
left at their defaults, and class 0 is never predicted (``pred_ignore0``).
Every epoch's shuffle and draws come from generators derived from (seed,
epoch), so a resumed run trains as an unbroken one (the JAX CLI draws from
one host ``RandomState`` in sequence).

``--workers N`` builds the training batches in N processes
(``runtime.PrefetchLoader``: batch i of epoch e seeded seed + e * 100003 +
i, the same batches for any N >= 1), uploaded from pinned staging buffers.
``--n_devices N`` runs one process a card (``torch.multiprocessing`` spawn,
NCCL on the cards, gloo with ``--device cpu``), each stepping its rows of
every global batch through ``parallel.shard_step`` with ``--bn per_device``
(each rank's own statistics and buffers) or ``sync`` (statistics over the
ranks); ``global`` at N > 1 is ``sync``, at N = 1 the plain in-process step.
Rank 0 alone logs, validates with its buffers and saves checkpoints.
"""

import argparse
import contextlib
import dataclasses
import json
import logging
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
    p.add_argument("--dataset", type=str, default="S3DIS", choices=["S3DIS", "ScanNet"])
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
                   help="processes, one a card (default 1)")
    p.add_argument("--bn", type=str, default="global",
                   choices=["global", "per_device", "sync"],
                   help="global = statistics over the whole batch; per_device = each "
                        "rank's own (the reference's default); sync = over the ranks")
    p.add_argument("--workers", type=int, default=0,
                   help="prefetch worker processes (0 = synchronous)")
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
    if args.n_devices is not None and args.n_devices < 1:
        p.error(f"--n_devices {args.n_devices}: at least 1")
    if args.workers < 0:
        p.error(f"--workers {args.workers}: at least 0")
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


class PaddedBatches:
    """The loader's ``make_batch``: the samples of ``indices`` drawn from
    ``RandomState(seed)`` in order, padded to ``n_max`` points and to a
    multiple of ``multiple`` samples (the JAX CLI's ``make_train_batch``)."""

    def __init__(self, dataset, n_max, ignore_label, multiple=1):
        self.dataset, self.n_max = dataset, n_max
        self.ignore_label, self.multiple = ignore_label, multiple

    def __call__(self, indices, seed):
        return self.build(indices, np.random.RandomState(seed))

    def build(self, indices, rng):
        """The padded batch of ``indices``, drawing from ``rng`` in order."""
        from ..data.s3dis import pad_batch
        from ..parallel.mesh import pad_to_multiple

        samples = [self.dataset.get(int(i), rng=rng) for i in indices]
        batch = pad_batch(samples, self.n_max, self.ignore_label)
        return pad_to_multiple(batch, self.multiple, self.ignore_label)


class _Silent:
    """The scalar writer of a rank that does not write."""

    def add_scalar(self, *a):
        pass


def main(argv=None):
    """Train; returns the ``SegRun`` of this process, or None when the
    ranks ran in processes of their own (``--n_devices`` > 1)."""
    from ..parallel.distributed import free_port, spawn

    args = parse_args(argv)
    n = args.n_devices or 1
    if n == 1:
        return _run(0, args, 1, None)
    if args.device.startswith("cuda") and torch.cuda.device_count() < n:
        raise SystemExit(f"--n_devices {n}: {torch.cuda.device_count()} CUDA devices here")
    spawn(_run, n, args=(args, n, f"tcp://127.0.0.1:{free_port()}"))
    return None


def _run(rank, args, world, init_method):
    from ..parallel import distributed

    dp = world > 1 or args.bn != "global"
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {args.device}: no CUDA device here (use --device cpu)")
        device = torch.device("cuda", (device.index or 0) + rank)
        torch.cuda.set_device(device)
    elif world > 1:  # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    if not dp:
        return _train(args, device)
    distributed.init_distributed("nccl" if device.type == "cuda" else "gloo", world, rank,
                                 init_method)
    try:
        return _train(args, device, bn="sync" if args.bn == "global" else args.bn)
    finally:
        distributed.shutdown()


def _train(args, device, bn=None):
    """The training loop on ``device``; ``bn`` names the data-parallel
    step's mode (None: the plain step, no process group)."""
    from ..config import S3DIS_AUG_ARGS
    from ..data import scannet
    from ..data.aug import coord_transform_from_flags, rgb_transform_from_flags
    from ..data.s3dis import CLASS_WEIGHTS, S3DISDataset
    from ..data.synthetic_scene import SyntheticRooms
    from ..nn.metrics import iou_from_counts
    from ..ops.kernels import kernel_launches
    from ..parallel.distributed import process_info
    from ..parallel.mesh import shard_batch
    from ..runtime import PrefetchLoader
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

    rank, world = process_info()
    main_rank = rank == 0
    # per-dataset constants (reference tool/train.py:452-470)
    if args.dataset == "ScanNet":
        num_class, ignore = scannet.NUM_CLASS, scannet.IGNORE_LABEL
        if args.voxel_size == 0.04:
            args.voxel_size = scannet.VOXEL_SIZE
        if args.voxel_max == 80000:
            args.voxel_max = scannet.VOXEL_MAX
        if args.loop == 30:
            args.loop = scannet.LOOP
    else:
        num_class, ignore = 13, 255
    cfg = SegConfig(
        model=args.model, dataset=args.dataset, num_class=num_class, ignore_label=ignore,
        pred_ignore0=args.dataset == "ScanNet", test_area=args.test_area,
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

    exp = os.path.join(args.log_root, cfg.dataset, args.log_dir or "default")
    log_dir = os.path.join(exp, "logs")
    if main_rank:
        logger = get_logger(log_dir, "train_seg")
    else:
        logger = logging.getLogger(f"train_seg.rank{rank}")
        logger.addHandler(logging.NullHandler())
        logger.propagate = False
    logger.info(cfg)

    init_gen = set_seed(cfg.seed)
    coord_t = coord_transform_from_flags(cfg, S3DIS_AUG_ARGS)
    rgb_t = rgb_transform_from_flags(cfg)
    sizes = dict(voxel_size=cfg.voxel_size, voxel_max=cfg.voxel_max)
    if args.synthetic:
        train_set = SyntheticRooms(
            "train", n_rooms=args.synthetic_rooms, raw_points=args.synthetic_raw,
            loop=cfg.loop, coord_transform=coord_t, rgb_transform=rgb_t, shuffle_index=True,
            seed=cfg.seed, **sizes)
        val_set = SyntheticRooms(
            "val", n_rooms=max(2, args.synthetic_rooms // 4), raw_points=args.synthetic_raw,
            loop=1, seed=cfg.seed, **sizes)
    elif cfg.dataset == "ScanNet":
        train_set = scannet.ScanNetDataset(args.data_dir, "train", loop=cfg.loop,
                                           coord_transform=coord_t, rgb_transform=rgb_t,
                                           shuffle_index=True, **sizes)
        val_set = scannet.ScanNetDataset(args.data_dir, "val", loop=cfg.loop, **sizes)
    else:
        train_set = S3DISDataset(
            args.data_dir, "train", test_area=cfg.test_area, loop=cfg.loop,
            coord_transform=coord_t, rgb_transform=rgb_t, shuffle_index=True, **sizes)
        val_set = S3DISDataset(args.data_dir, "val", test_area=cfg.test_area, loop=cfg.loop,
                               **sizes)
    logger.info(f"train rooms={len(train_set.rooms)} val rooms={len(val_set.rooms)}")

    model = build_model(cfg, generator=init_gen).to(device)
    opt = make_optimizer(model, cfg)
    logger.info(f"{cfg.model}: {sum(p.numel() for p in model.parameters())} parameters on "
                f"{device}")
    weights = scannet.CLASS_WEIGHTS if cfg.dataset == "ScanNet" else CLASS_WEIGHTS[cfg.test_area]
    class_weight = torch.tensor(weights, dtype=torch.float32, device=device)
    ckpt = BestCheckpointer(os.path.join(exp, "checkpoints")) if main_rank else None
    best_iou, start_epoch = 0.0, 0
    if args.resume or args.pretrain:
        path = _checkpoint_file(args.resume or args.pretrain)
        restored = torch.load(path, map_location=device, weights_only=True)
        start_epoch, best_iou = apply_train_state(model, opt, restored,
                                                  weights_only=args.pretrain is not None)
        if ckpt is not None:
            ckpt.best_metric = best_iou
        logger.info(f"restored from {path} (epoch {start_epoch}, best {best_iou:.4f})")
    if bn is not None:
        from ..parallel.shard_step import make_seg_train_step

        dp_step = make_seg_train_step(cfg, bn=bn)
        logger.info(f"data-parallel step over {world} processes, bn={bn}")

    make_train_batch = PaddedBatches(train_set, cfg.voxel_max, cfg.ignore_label, world)

    def to_device(batch):
        return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}

    def batches(ds, bs, rng, shuffle, multiple=1):
        make = PaddedBatches(ds, cfg.voxel_max, cfg.ignore_label, multiple)
        order = np.arange(len(ds))
        if shuffle:
            rng.shuffle(order)
        for s in range(0, len(order) - bs + 1, bs):
            yield make.build(order[s:s + bs], rng)

    def counts(parts):
        return np.stack([p.cpu().numpy() for p in parts]).astype(np.float64)

    loader = upload = None
    if args.workers > 0:
        loader = PrefetchLoader(make_train_batch, n_items=len(train_set),
                                batch_size=cfg.batch_size, n_workers=args.workers,
                                seed=cfg.seed)
        if device.type == "cuda":
            base = loader.to_device(device)

            def upload(batch, slot):
                return base(shard_batch(batch, rank, world), slot)

    losses = {}
    with contextlib.ExitStack() as stack:
        if loader is not None:
            stack.callback(loader.close)
        writer = stack.enter_context(ScalarWriter(log_dir)) if main_rank else _Silent()
        for epoch in range(start_epoch, cfg.epoch):
            set_lr(opt, epoch_lr(cfg, epoch))
            freeze = is_frozen(cfg, epoch)
            gen = epoch_generator(cfg.seed, epoch, device)
            rng = np.random.RandomState(derive_seed(cfg.seed, epoch) % 2**32)
            if loader is None:
                epoch_batches = (to_device(shard_batch(b, rank, world))
                                 for b in batches(train_set, cfg.batch_size, rng, True, world))
            elif upload is not None:
                epoch_batches = loader.epoch(epoch, upload)
            else:
                epoch_batches = (shard_batch(b, rank, world) for b in loader.epoch(epoch))
            timer = StepTimer()
            tot = np.zeros((3, cfg.num_class))
            step_losses, step_s = [], []
            for i, batch in enumerate(epoch_batches):
                timer.data_loaded()
                if bn is None:
                    loss, parts = train_step(model, opt, batch, class_weight, cfg,
                                             generator=gen, freeze=freeze)
                else:
                    loss, parts = dp_step(model, opt, batch, class_weight, freeze=freeze,
                                          generator=epoch_generator(cfg.seed, epoch, device, i,
                                                                    rank))
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
            peak = (f", peak {torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB"
                    if device.type == "cuda" else "")
            logger.info(
                f"train epoch {epoch + 1}/{cfg.epoch}: loss {loss:.6f} mIoU/mAcc/OA "
                f"{miou * 100:.2f}/{macc * 100:.2f}/{allacc * 100:.2f} lr {epoch_lr(cfg, epoch):g}"
                f"{' frozen' if freeze else ''}; {len(step_losses)} steps, step median "
                f"{statistics.median(step_s):.4f} s, data {timer.data.avg:.4f} s{peak}")
            writer.add_scalar("loss_train", loss, epoch + 1)
            writer.add_scalar("mIoU_train", miou, epoch + 1)
            writer.add_scalar("mAcc_train", macc, epoch + 1)
            writer.add_scalar("allAcc_train", allacc, epoch + 1)

            if main_rank and epoch + 1 > cfg.min_val and (epoch + 1) % cfg.val_freq == 0:
                tot = np.zeros((3, cfg.num_class))
                vlosses, predicted = [], np.zeros(cfg.num_class, np.int64)
                vrng = np.random.RandomState(derive_seed(cfg.seed, epoch, 1) % 2**32)
                for batch in batches(val_set, cfg.batch_size_val, vrng, False):
                    batch = to_device(batch)
                    vloss, pred, parts = eval_step(model, batch, class_weight, cfg)
                    vlosses.append(float(vloss))
                    tot += counts(parts)
                    live = (torch.arange(pred.shape[1], device=device)[None, :]
                            < batch["valid"][:, None])
                    predicted += torch.bincount(pred[live], minlength=cfg.num_class).cpu().numpy()
                miou, macc, allacc = (float(x) for x in iou_from_counts(*torch.from_numpy(tot)))
                logger.info(f"val epoch {epoch + 1}: mIoU/mAcc/OA {miou * 100:.2f}/"
                            f"{macc * 100:.2f}/{allacc * 100:.2f} loss {np.mean(vlosses):.4f}")
                logger.info(f"predicted points by class, val epoch {epoch + 1}: "
                            f"{predicted.tolist()}")
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
