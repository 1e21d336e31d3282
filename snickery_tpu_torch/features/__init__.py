"""Feature helpers of the port that need neither jax nor torch."""
