#!/usr/bin/env python3
"""Readings behind the offline/online split's checks (CPU).

    python3 scripts/torch_cache_reference.py count [--blocks 12 --width 48]
        the port: compile_parties_cached over a compressed GPT-2 of that
        depth and width (12 heads, vocab 1000 in 8 chunks, seq 64) under
        bench.py's kernel configuration: the recorded requests by provider
        method, and the fill's launches they make on a card (philox by
        chip_smoke.PROVIDER_LAUNCHES, ring_mm one a matmul triple's dealer
        product). The counts do not depend on the width; chip_smoke's
        phase 10 holds the card's fill to them.

    JAX_PLATFORMS=cpu python3 scripts/torch_cache_reference.py reference
        both packages over the tiny compressed GPT of
        tests/test_torch_compiled.py (16 wide, 1 block, vocab 64 in 4
        chunks, seq 8) under the scan_reduction max and no fused knob
        (curl_tpu takes none off a TPU): curl_tpu's compile_parties_cached
        online counted at trace against its uncached compile_parties
        (rounds, bytes), the port's online against its compile_parties,
        and the requests each package records, by method. curl_tpu records
        each lax.scan body once, so its online serves one entry to every
        iteration of a scan; the port's loops record one an iteration.
        About a minute (curl_tpu's traces).

Prints one JSON line.
"""

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def by_func(requests):
    funcs = [r.func for r in requests]
    return {f: funcs.count(f) for f in sorted(set(funcs))}


def count(blocks, width):
    import chip_smoke as cs
    import curl_tpu_torch as ct
    from curl_tpu_torch.config import cfg
    from curl_tpu_torch.models import GPT

    seq, vocab = 64, 1000
    sd = cs.random_gpt2_state(np.random.default_rng(0), seq, blocks, d=width, vocab=vocab)
    tokens = np.random.default_rng(0).integers(0, vocab, size=(1, seq)).astype(np.float64)
    ct.init(world_size=2, seed=cs.SEED, device="cpu")
    with cfg.temp_override(cs.BENCH_CONFIG):
        model = GPT.build_compressed(width, 12, blocks, vocab, seq,
                                     head_vocab_chunks=cs.HEAD_CHUNKS, state_dict=sd)
        apply_fn, params = model.functional()
        _, fill = ct.compile_parties_cached(apply_fn, 2, cs.CACHE_RECORD_SEED, params,
                                            ct.cryptensor(tokens, precision=0))
    return {"blocks": blocks, "width": width, "requests": len(fill.requests),
            "by_method": by_func(fill.requests),
            "fill_launches": {
                "philox": sum(cs.PROVIDER_LAUNCHES[f] for f in fill.funcs),
                "ring_mm": sum(1 for r in fill.requests
                               if r.func == "generate_additive_triple" and r.args[2] == "matmul")}}


def reference():
    import conftest  # noqa: F401  (JAX on the CPU, x64)
    import jax

    import curl_tpu
    from curl_tpu import models as jmodels
    from curl_tpu.parallel import compile_parties_cached

    import curl_tpu_torch as ct
    from curl_tpu_torch import parallel
    from curl_tpu_torch.config import cfg
    from curl_tpu_torch.models import GPT
    from test_torch_compiled import BENCH, GEOM, _state, _tokens

    config = {"functions.max_method": BENCH["functions.max_method"]}
    curl_tpu.init(world_size=2, seed=21)
    with curl_tpu.cfg.temp_override(config):
        m = jmodels.GPT.build_compressed(**GEOM, head_vocab_chunks=4, chunk_block_linears=True)
        apply_fn, params = m.functional()
        xe = curl_tpu.cryptensor(_tokens(), precision=0)
        online, fill = compile_parties_cached(apply_fn, 2, 5, params, xe.mpc)
        jax_requests = by_func(curl_tpu.get_default_provider().requests)
        entries = jax.eval_shape(fill, jax.random.PRNGKey(11))
        curl_tpu.reset_communication_stats()
        jax.eval_shape(online, jax.random.PRNGKey(12), entries, params, xe.mpc)
        s = curl_tpu.comm.get_communication_stats()
        jax_online = (s["rounds"], s["bytes"])
        curl_tpu.reset_communication_stats()
        jax.make_jaxpr(curl_tpu.compile_parties(apply_fn, world_size=2))(
            jax.random.PRNGKey(5), params, xe.mpc)
        s = curl_tpu.comm.get_communication_stats()
        jax_uncached = (s["rounds"], s["bytes"])

    with cfg.temp_override(config):
        ct.init(world_size=2, seed=21, device="cpu")
        model = GPT.build_compressed(**GEOM, head_vocab_chunks=4, chunk_block_linears=True,
                                     state_dict=_state(0))
        apply_fn, params = model.functional()
        pxe = ct.cryptensor(_tokens(), precision=0)
        online, fill = parallel.compile_parties_cached(apply_fn, 2, 99, params, pxe)
        online(101, fill(97), params, pxe)
        step = parallel.compile_parties(apply_fn, 2)
        step(101, params, pxe)
    return {"curl_tpu": {"online_at_trace": jax_online, "uncached_at_trace": jax_uncached,
                         "requests": sum(jax_requests.values()), "by_method": jax_requests},
            "port": {"online": (online.stats["rounds"], online.stats["bytes"]),
                     "uncached": (step.stats["rounds"], step.stats["bytes"]),
                     "requests": len(fill.requests), "by_method": by_func(fill.requests)}}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=["count", "reference"])
    ap.add_argument("--blocks", type=int, default=12)
    ap.add_argument("--width", type=int, default=48)
    args = ap.parse_args()
    out = count(args.blocks, args.width) if args.mode == "count" else reference()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
