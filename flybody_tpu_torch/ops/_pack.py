"""Constant-table packs for the stage kernels (see csrc/common.cuh).

A kernel's model tables travel as one float32 array and one int32 array;
the int array starts with the offset of every table. The order of the
names given here is the order of the kernel's table enums.
"""

from __future__ import annotations

import numpy as np
import torch


class Pack:
    def __init__(self, floats: list, ints: list):
        """floats / ints: lists of (name, array) in enum order."""
        self.fnames = [n for n, _ in floats]
        self.inames = [n for n, _ in ints]
        fparts = [np.asarray(a, np.float64).reshape(-1) for _, a in floats]
        iparts = [np.asarray(a, np.int64).reshape(-1) for _, a in ints]
        foff = np.cumsum([0] + [len(p) for p in fparts])[:-1]
        head = len(floats) + len(ints)
        ioff = head + np.cumsum([0] + [len(p) for p in iparts])[:-1]
        self.floats64 = np.concatenate(fparts + [np.zeros(1)])
        self.floats = self.floats64.astype(np.float32)
        self.ints = np.concatenate(
            [foff, ioff] + iparts + [np.zeros(1, np.int64)]).astype(np.int32)
        self._dev = {}

    def table(self, name: str, float64: bool = False) -> np.ndarray:
        """One table by name, as packed (float32 or int32); float64: a float
        table before its rounding to float32."""
        if name in self.fnames:
            i, off, n = self.fnames.index(name), 0, self.nf
            arr = self.floats64 if float64 else self.floats
        else:
            i, arr, off, n = (self.inames.index(name), self.ints, self.nf,
                              self.ni)
        lo = self.ints[off + i]
        hi = self.ints[off + i + 1] if i + 1 < n else len(arr) - 1
        return arr[lo:hi]

    @property
    def nf(self) -> int:
        return len(self.fnames)

    @property
    def ni(self) -> int:
        return len(self.inames)

    def on(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        key = str(device)
        if key not in self._dev:
            self._dev[key] = (torch.as_tensor(self.floats, device=device),
                              torch.as_tensor(self.ints, device=device))
        return self._dev[key]
