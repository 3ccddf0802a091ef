"""Plain float32 references of what the cells time, in plain PyTorch.

They import neither JAX nor the JAX package nor the port: weights come as a
dict of float32 tensors keyed by parameter name, drawn again from the seed
by ``portbench.weights``; every table (position encodings, pooling) is
worked out here.  TF32 stays off.  Each product takes its operands through
a rounding function, the identity for the reference and a lower precision
for the controls (``precision.py``).
"""
