"""Classification training CLI: the port's counterpart of tools/train_cls.py
(classification/tool/train_cls_scanobjectnn.py).

  python -m repsurf_torch.cli.train_cls --data_dir ./data \\
      --model repsurf.repsurf_ssg_umb --batch_size 64 --epoch 250 \\
      --group_size 8 --umb_pool sum --num_point 1024

``--synthetic`` trains on ``SyntheticClouds`` (512 training, 128 test
clouds) instead of the ScanObjectNN h5 files.  Logs, scalars
(``scalars.jsonl``) and the best checkpoint go under
``<log_root>/ScanObjectNN/<log_dir>/``; a run resumes silently from that
checkpoint when one is there.  Every epoch's draws come from generators
derived from (seed, epoch), so a resumed run draws what an unbroken one
would have.  The JAX CLI's ``--dp_mode shard_map`` / ``--n_devices`` (data
parallelism) are not ported.
"""

import argparse
import json
import os
import pickle

import numpy as np
import torch

from ..models import CLS_MODELS


def parse_args(argv=None):
    p = argparse.ArgumentParser("RepSurf classification (PyTorch)")
    p.add_argument("--log_dir", type=str, default=None)
    p.add_argument("--data_dir", type=str, default="./data")
    p.add_argument("--log_root", type=str, default="./log")
    p.add_argument("--model", default="repsurf.repsurf_ssg_umb",
                   help="one of " + ", ".join(CLS_MODELS))
    p.add_argument("--seed", type=int, default=2800)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--optimizer", type=str, default="Adam")
    p.add_argument("--epoch", default=250, type=int)
    p.add_argument("--learning_rate", default=0.001, type=float)
    p.add_argument("--decay_rate", type=float, default=1e-4)
    p.add_argument("--decay_step", default=20, type=int)
    p.add_argument("--init", type=str, default=None)
    p.add_argument("--min_val", type=int, default=100)
    p.add_argument("--aug_scale", action="store_true", default=False)
    p.add_argument("--aug_shift", action="store_true", default=False)
    p.add_argument("--num_point", type=int, default=1024)
    p.add_argument("--return_dist", action="store_true", default=True)
    p.add_argument("--return_center", action="store_true", default=True)
    p.add_argument("--return_polar", action="store_true", default=True)
    p.add_argument("--group_size", type=int, default=8)
    p.add_argument("--umb_pool", type=str, default="sum")
    p.add_argument("--synthetic", action="store_true", default=False,
                   help="train on synthetic clouds (no dataset needed)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (cuda, cuda:1, cpu)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..data.scanobjectnn import ScanObjectNNDataset, SyntheticClouds
    from ..ops.kernels import kernel_launches
    from ..train.checkpoint import BestCheckpointer, apply_train_state, train_state_dict
    from ..train.train_cls import (
        ClsConfig,
        build_model,
        evaluate,
        make_optimizer,
        train_epoch,
    )
    from ..utils import derive_seed, epoch_generator, get_logger, ScalarWriter, set_seed

    cfg = ClsConfig(
        model=args.model,
        batch_size=args.batch_size,
        epoch=args.epoch,
        optimizer=args.optimizer,
        learning_rate=args.learning_rate,
        decay_rate=args.decay_rate,
        decay_step=args.decay_step,
        min_val=args.min_val,
        seed=args.seed,
        aug_scale=args.aug_scale,
        aug_shift=args.aug_shift,
        num_point=args.num_point,
        return_dist=args.return_dist,
        return_center=args.return_center,
        return_polar=args.return_polar,
        group_size=args.group_size,
        umb_pool=args.umb_pool,
        init_type=args.init,
    )
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device here (use --device cpu)")

    run_dir = os.path.join(args.log_root, "ScanObjectNN", args.log_dir or "default")
    log_dir = os.path.join(run_dir, "logs")
    logger = get_logger(log_dir, "train_cls")
    logger.info(cfg)

    init_gen = set_seed(cfg.seed)
    if args.synthetic:
        train_set = SyntheticClouds(n_samples=512, seed=0)
        test_set = SyntheticClouds(n_samples=128, seed=1)
    else:
        data_path = os.path.join(args.data_dir, "ScanObjectNN")
        train_set = ScanObjectNNDataset(data_path, split="training")
        test_set = ScanObjectNNDataset(data_path, split="test")
    logger.info(f"train={len(train_set)} test={len(test_set)}")

    model = build_model(cfg, generator=init_gen).to(device)
    opt = make_optimizer(model, cfg)
    logger.info(f"{cfg.model}: {sum(p.numel() for p in model.parameters())} parameters on "
                f"{device}")
    ckpt = BestCheckpointer(os.path.join(run_dir, "checkpoints"))

    # silent auto-resume from the best checkpoint, as the reference's bare
    # try/except restore (train_cls_scanobjectnn.py:166-172)
    start_epoch, best_sing, best_vote = 0, 0.0, 0.0
    if ckpt.exists():
        try:
            restored = ckpt.restore(map_location=device)
            start_epoch, best_vote = apply_train_state(model, opt, restored)
            ckpt.best_metric = best_vote
            logger.info(f"resumed from epoch {start_epoch} (vote {best_vote:.4f})")
        except (RuntimeError, KeyError, ValueError, pickle.UnpicklingError) as e:
            logger.info(f"no usable checkpoint ({e}); training from scratch")

    with ScalarWriter(log_dir) as writer:
        for epoch in range(start_epoch, cfg.epoch):
            gen = epoch_generator(cfg.seed, epoch, device)
            shuffle = np.random.RandomState(derive_seed(cfg.seed, epoch) % 2**32)
            loss, acc = train_epoch(model, opt, train_set, cfg, epoch, gen, rng=shuffle)
            logger.info(f"epoch {epoch + 1}/{cfg.epoch} loss {loss:.4f} acc {acc * 100:.2f}")
            writer.add_scalar("loss_train", loss, epoch + 1)
            writer.add_scalar("acc_train", acc, epoch + 1)
            if epoch >= cfg.min_val:
                sing, vote = evaluate(model, test_set, cfg,
                                      epoch_generator(cfg.seed, epoch, device, 999), device)
                best_sing = max(best_sing, sing)
                if vote >= best_vote:
                    best_vote = vote
                    ckpt.maybe_save(vote, epoch + 1,
                                    train_state_dict(model, opt, epoch + 1, vote))
                logger.info(
                    f"single {sing * 100:.2f} (best {best_sing * 100:.2f}) "
                    f"vote {vote * 100:.2f} (best {best_vote * 100:.2f})"
                )
                writer.add_scalar("acc_single_val", sing, epoch + 1)
                writer.add_scalar("acc_vote_val", vote, epoch + 1)
    logger.info("done")
    logger.info(f"kernel launches {json.dumps(kernel_launches())}")


if __name__ == "__main__":
    main()
