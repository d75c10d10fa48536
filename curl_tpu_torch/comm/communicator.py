"""Party-axis communicator: MPC collectives as reductions over dim 0.

Counterpart of ``curl_tpu/comm/communicator.py``. The JAX package writes
protocol code per party and binds the party as a named vmap axis; here the
parties are the explicit leading axis of every share tensor, ``(P, ...)``, so

  reference / JAX package              here
  --------------------------------------------------------------
  all_reduce(SUM)  / lax.psum           all_sum  -> sum over dim 0
  all_reduce(BXOR) / all_gather + xor   all_xor  -> xor over dim 0
  isend/irecv ring / lax.ppermute       ppermute -> roll over dim 0

and a revealed value is a public tensor without the party axis.

Rounds and bytes are counted exactly as the JAX package counts them: one
round per collective call (a list is one batched reveal) and, per call, the
bytes of ONE party's message (the per-party share size times 8).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import torch

_WORLD_SIZE = 1
_DEVICE = None


def set_world_size(n: int):
    global _WORLD_SIZE
    _WORLD_SIZE = int(n)


def get_world_size() -> int:
    return _WORLD_SIZE


def set_device(device):
    global _DEVICE
    _DEVICE = torch.device(device)


def get_device() -> torch.device:
    if _DEVICE is None:
        raise RuntimeError("curl_tpu_torch.init() must be called first")
    return _DEVICE


def rank_mask(src: int, ndim: int) -> torch.Tensor:
    """(P, 1, ..., 1) int64 mask that is 1 on party ``src`` only: the
    party-axis form of the JAX package's ``rank == src`` selections
    (beaver._rank0, random.przs_share). ``ndim`` is the per-party rank of
    the tensor it multiplies."""
    m = torch.zeros((_WORLD_SIZE,) + (1,) * ndim, dtype=torch.int64, device=get_device())
    m[src] = 1
    return m


# ---------------------------------------------------------------------------
# Stats
# ---------------------------------------------------------------------------

@dataclass
class CommStats:
    rounds: int = 0
    bytes: int = 0
    calls: dict = field(default_factory=dict)

    def reset(self):
        self.rounds = 0
        self.bytes = 0
        self.calls = {}


comm_stats = CommStats()


def _count(name, tensors):
    comm_stats.rounds += 1
    comm_stats.bytes += sum(t[0].numel() * t.element_size() for t in tensors)
    comm_stats.calls[name] = comm_stats.calls.get(name, 0) + 1


def register_virtual(name, nbytes, rounds=1):
    """Account communication a fused kernel performs internally (the same
    messages and bytes as the composable protocol path)."""
    for _ in range(rounds):
        comm_stats.rounds += 1
        comm_stats.calls[name] = comm_stats.calls.get(name, 0) + 1
    comm_stats.bytes += int(nbytes)


def add_communication_stats(stats: dict):
    """Count ``stats`` (``get_communication_stats``'s form, the difference
    one run made) once more: a captured program's rounds, bytes and calls,
    each time it runs."""
    comm_stats.rounds += stats["rounds"]
    comm_stats.bytes += stats["bytes"]
    for name, n in stats["calls"].items():
        comm_stats.calls[name] = comm_stats.calls.get(name, 0) + n


def reset_communication_stats():
    comm_stats.reset()


def print_communication_stats():
    """The counters through ``logging.info``, in curl_tpu's words
    (curl_tpu/comm/communicator.py:141)."""
    logging.info("====Communication Stats====")
    logging.info("Rounds: %d", comm_stats.rounds)
    logging.info("Bytes: %d", comm_stats.bytes)
    for k, v in sorted(comm_stats.calls.items()):
        logging.info("  %s: %d", k, v)


def get_communication_stats():
    """Snapshot of the communication counters as a plain dict."""
    return {
        "rounds": comm_stats.rounds,
        "bytes": comm_stats.bytes,
        "calls": dict(comm_stats.calls),
    }


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def _reduce(name, x, op):
    if _WORLD_SIZE < 2:
        return [t[0] for t in x] if isinstance(x, (list, tuple)) else x[0]
    tensors = list(x) if isinstance(x, (list, tuple)) else [x]
    _count(name, tensors)
    outs = []
    for t in tensors:
        acc = t[0].clone()
        for p in range(1, t.shape[0]):
            op(acc, t[p])
        outs.append(acc)
    return outs if isinstance(x, (list, tuple)) else outs[0]


def all_sum(x):
    """Reveal-sum over the party axis (arithmetic share reconstruction).
    ``x``: a (P, ...) share tensor or a list of them (one batched round)."""
    return _reduce("all_sum", x, torch.Tensor.add_)


def all_xor(x):
    """XOR-reduce over the party axis (binary share reconstruction)."""
    return _reduce("all_xor", x, torch.Tensor.bitwise_xor_)


def all_gather(x):
    """Every party receives every party's share: the (P, ...) stack itself,
    now public. One round of one party's share."""
    if _WORLD_SIZE >= 2:
        _count("all_gather", [x])
    return x


def ppermute(x, shift: int = 1):
    """Ring pass (curl_tpu/comm/communicator.py:235-241): party p sends its
    share to party p + shift and receives party p - shift's, so row p of
    the result is row p - shift of ``x``. One round of one party's share;
    a list of (P, ...) tensors is one round."""
    if _WORLD_SIZE < 2:
        return x
    tensors = list(x) if isinstance(x, (list, tuple)) else [x]
    _count("ppermute", tensors)
    outs = [torch.roll(t, shift, dims=0) for t in tensors]
    return outs if isinstance(x, (list, tuple)) else outs[0]


def scatter(stacked, src: int):
    """Party p receives row p of a (P, ...) stack held by party ``src``,
    sent as one broadcast of the whole stack (the JAX package's scatter)."""
    if _WORLD_SIZE >= 2:
        comm_stats.rounds += 1
        comm_stats.bytes += stacked.numel() * stacked.element_size()
        comm_stats.calls["broadcast"] = comm_stats.calls.get("broadcast", 0) + 1
    return stacked
