"""Plain PyTorch and Python references the benchmark checks the port against.

They import nothing of the port and nothing of JAX: each works its answer
out again from the inputs the benchmark makes from the seed.
"""
