"""Classification vote evaluation, the segmentation train and eval steps,
the optimizer, and the weight transfer from the JAX package's flax trees."""
