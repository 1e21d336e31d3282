"""Compute ops of the port: preselect (CUDA kernel + plain twin), Viterbi,
overlap-add."""
