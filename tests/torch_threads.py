"""One PyTorch intra-op thread per test process.

The tier-1 suite runs in several pytest-xdist workers at once, and each
worker collects every test module. PyTorch's default is a thread per core
in every worker, so six workers on eight cores ran up to 48 intra-op
threads beside XLA's own pools: the port's tests, most of them torch on
the CPU, spent most of their CPU time contending. Every port test module
imports this module, so the first one a worker collects limits torch to
one thread there. The port's float reductions fix their own order
(`ops.aggregate.blocked_sum`), and the suite passes the same either way.
"""
import torch

torch.set_num_threads(1)
