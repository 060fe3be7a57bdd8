"""Count the operations a call issues to PyTorch's dispatcher.

``count_ops(fn)`` runs fn under a dispatch mode that tallies every aten
operation by name, after PyTorch's own decompositions and before any
device kernel: the host's program, whatever the tensors' sizes. Kernel
launches can differ where a library picks its algorithm by size (a sort,
a matrix product, an eigen solve); the operations do not. A batched
solve that issues the same operations at every batch size is one
program over the batch, not a loop over it.
"""
from __future__ import annotations

import collections

from torch.utils._python_dispatch import TorchDispatchMode


class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func.name()] += 1
        return func(*args, **(kwargs or {}))


def count_ops(fn):
    """(fn(), Counter of the aten operations fn issued, by name)."""
    counter = _OpCounter()
    with counter:
        out = fn()
    return out, counter.ops
