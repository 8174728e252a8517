"""Classification vote evaluation and the weight transfer from the JAX
package's flax trees."""
