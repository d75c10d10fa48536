"""The standalone dealer: fill tuple caches in a process of its own and ship
each party only its slice.

Counterpart of ``curl_tpu/mpc/provider/dealer.py`` and ``scripts/dealer.py``
(the reference runs its TTP as a server process,
curl/mpc/provider/ttp_provider.py:256-306). The offline/online split takes
the place of the request loop:

  1. a party session records its tuple requests (``ct.trace(True)``, or
     ``compile_parties_cached``) and ships the request file
     (``provider.save_requests``, JSON);
  2. the dealer, this module's command line, generates them under its own
     seed, which never leaves its host, and writes one file a party, each
     holding only that party's share of every entry (and party 0's file
     the dealer plaintexts, the trusted first party's own);
  3. each party loads the files (``attach_party_caches``) and its eager ops
     pop the entries in order.

    python -m curl_tpu_torch.mpc.provider.dealer --requests F \\
        --world-size 2 --seed S --out PREFIX [--device cpu]

writes ``PREFIX.party{r}.npz`` for each party r. It runs on the CUDA card
(the tuples drawn by the ``philox`` kernel and the dealer products by
``ring_mm``) and raises where there is none, unless ``--device cpu``.
TFP only: the TTP provider is not ported. No file holds a pickle.
"""

from __future__ import annotations

import argparse

import torch

from ... import comm
from ... import random as rng
from .provider import TupleCache, describe, leaf_kinds, read_npz, rebuild, write_npz

PARTY_FORMAT = "curl_tpu_torch tuple cache, one party"


def fill_standalone(requests, world_size: int, seed, provider=None) -> TupleCache:
    """Generate ``requests`` in the calling (dealer) process under the keys
    of ``seed``, from the session's draw counter: a cache of party-stacked
    entries (every share tensor's axis 0 is the party axis)."""
    from ...parallel.runner import mpc_context
    from .. import get_default_provider

    provider = provider or get_default_provider()
    requests = list(requests)
    with mpc_context(rng.make_party_keys(int(seed), world_size), world_size):
        entries = provider.fill_cache_entries(requests)
    return TupleCache(entries, funcs=[r.func for r in requests])


def save_party_caches(cache: TupleCache, prefix: str, world_size: int):
    """Write ``{prefix}.party{r}.npz`` for each party r, holding party r's
    slice of every share tensor; party 0's also holds the dealer
    plaintexts. Returns the paths."""
    desc, leaves = describe(cache.entries, cache.funcs)
    kinds = leaf_kinds(desc)
    paths = []
    for r in range(world_size):
        arrays = {i: (t[r] if kinds[i] == "shares" else t) for i, t in enumerate(leaves)
                  if kinds[i] == "shares" or r == 0}
        meta = {"format": PARTY_FORMAT, "version": 1, "world_size": world_size, "party": r,
                "entries": desc, "funcs": cache.funcs, "leaves": len(leaves)}
        path = f"{prefix}.party{r}.npz"
        write_npz(path, meta, arrays)
        paths.append(path)
    return paths


def load_party_caches(paths) -> TupleCache:
    """A party-stacked cache from the dealer's files, on the session's
    device. ``paths`` must cover every party once, in any order (each file
    names its party); a duplicate or a missing party raises ValueError, as
    does a file that is not the dealer's."""
    loaded, world_size, meta0 = {}, None, None
    for path in paths:
        meta, arrays = read_npz(path, PARTY_FORMAT)
        try:
            ws, party, n = int(meta["world_size"]), int(meta["party"]), int(meta["leaves"])
            kinds = leaf_kinds(meta["entries"])
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"{path}: not a party cache file ({e})") from None
        if world_size is None:
            world_size, meta0 = ws, meta
        if ws != world_size or meta["entries"] != meta0["entries"]:
            raise ValueError(f"{path}: another dealer run's file (world size {ws})")
        if party in loaded:
            raise ValueError(f"duplicate cache file for party {party}")
        loaded[party] = arrays
    missing = sorted(set(range(world_size or 0)) - set(loaded))
    if missing or not loaded:
        raise ValueError(f"missing cache files for parties {missing}")
    device = comm.get_device()
    leaves = []
    try:
        for i in range(n):
            if kinds[i] == "shares":
                leaves.append(torch.stack([torch.from_numpy(loaded[r][i])
                                           for r in range(world_size)]).to(device))
            else:
                leaves.append(torch.from_numpy(loaded[0][i]).to(device))
    except KeyError as e:
        raise ValueError(f"a party file lacks leaf {e}") from None
    return TupleCache(rebuild(meta0["entries"], leaves), funcs=meta0.get("funcs"))


def attach_party_caches(paths, provider=None) -> TupleCache:
    """Load the dealer's per-party files and make them the host cache."""
    from .. import get_default_provider

    provider = provider or get_default_provider()
    cache = load_party_caches(paths)
    provider.attach_cache(cache)
    return cache


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", required=True, help="a request file (provider.save_requests)")
    ap.add_argument("--world-size", type=int, required=True)
    ap.add_argument("--seed", type=int, default=0, help="the dealer's own seed")
    ap.add_argument("--out", required=True, help="writes {out}.party{r}.npz for each party")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; the CUDA card otherwise")
    args = ap.parse_args(argv)

    import curl_tpu_torch as ct
    from .provider import load_requests

    requests = load_requests(args.requests)  # raises before anything runs
    ct.init(world_size=args.world_size, seed=args.seed, device=args.device)
    cache = fill_standalone(requests, args.world_size, args.seed)
    for path in save_party_caches(cache, args.out, args.world_size):
        print(path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
