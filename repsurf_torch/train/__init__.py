"""The classification trainer (train step, epoch, vote evaluation), the
segmentation train and eval steps, the optimizers and schedules,
checkpoints, and the weight transfer from the JAX package's flax trees."""
