"""The session key table: the stream seeds the kernels read from the device.

A Philox-drawing kernel (``philox``, ``fused_mul``, ``max_step``) names each
of its streams by a slot of one small int64 table (``KeyTable``) instead of
carrying the seed in its launch parameters, as the JAX package's kernels
take their seeds as a runtime operand (``seed_ref`` in pallas_mul.py and
pallas_max_step.py, ``seeds`` in pallas_przs.py and pallas_rng.py). The
table is written in place and never reallocated, so a launch captured in a
CUDA graph reads whatever keys the table holds when the graph is replayed:
one captured forward serves every seed (``parallel/runner.py``).

The table keeps a host mirror of its values. The plain torch versions of
the kernels read the mirror, so a CPU run computes what it computed when
the keys were literal. A kernel's key is always a ``KeyRef``, ``rows``
consecutive slots of a table: the session's (``random.TABLE``) on the
forward, or one that ``hold`` makes for keys that are no session stream
(the kernels' tests and timings). Only the per-tensor keys of
seed-compressed weights, which ``seed_expand`` takes, stay literal.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

_M64 = (1 << 64) - 1


def _signed(v: int) -> int:
    """A 64-bit unsigned key as the int64 the table holds."""
    v &= _M64
    return v - (1 << 64) if v >= 1 << 63 else v


class KeyTable:
    """``size`` 64-bit keys on the host and, per CUDA device, in one int64
    tensor that is written in place and never reallocated."""

    def __init__(self, size: int):
        self.host = [0] * size
        self._devices = {}

    def write(self, values, start: int = 0):
        """Set slots ``start ..`` to ``values`` (unsigned 64-bit ints) on the
        host and, in stream order on each device's current stream, in every
        device copy."""
        values = [int(v) & _M64 for v in values]
        if start < 0 or start + len(values) > len(self.host):
            raise ValueError(f"key slots {start}..{start + len(values) - 1} outside the table")
        self.host[start:start + len(values)] = values
        if not self._devices:
            return
        src = torch.tensor([_signed(v) for v in values], dtype=torch.int64)
        for t in self._devices.values():
            staged = src.pin_memory() if t.is_cuda else src
            t[start:start + len(values)].copy_(staged, non_blocking=t.is_cuda)

    def tensor(self, device) -> torch.Tensor:
        """The table on ``device``, made from the host mirror on first use
        (before any capture: the first forward on a device makes it)."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        t = self._devices.get(device)
        if t is None:
            t = torch.tensor([_signed(v) for v in self.host], dtype=torch.int64, device=device)
            self._devices[device] = t
        return t

    def ref(self, slot: int, rows: int = 1) -> "KeyRef":
        if slot < 0 or rows < 1 or slot + rows > len(self.host):
            raise ValueError(f"key slots {slot}..{slot + rows - 1} outside the table")
        return KeyRef(self, slot, rows)


@dataclass(frozen=True)
class KeyRef:
    """``rows`` consecutive slots of a key table, from ``slot`` on."""

    table: KeyTable
    slot: int
    rows: int = 1

    def values(self) -> tuple:
        """The keys the slots hold now (the host mirror)."""
        return tuple(self.table.host[self.slot:self.slot + self.rows])

    def value(self) -> int:
        """The key that a single slot holds now (the host mirror)."""
        if self.rows != 1:
            raise ValueError("a single key names one slot")
        return self.table.host[self.slot]

    def pointer(self, device) -> int:
        """The device address of the first slot, for a launch."""
        return self.table.tensor(device).data_ptr() + 8 * self.slot


def hold(*rows) -> list:
    """One new key table holding each sequence of ``rows`` in turn, and a
    ``KeyRef`` to each: the slots through which keys that are no session
    stream (a test's, a timing's) reach a kernel."""
    table = KeyTable(sum(len(r) for r in rows))
    refs, slot = [], 0
    for r in rows:
        table.write(r, slot)
        refs.append(table.ref(slot, len(r)))
        slot += len(r)
    return refs
