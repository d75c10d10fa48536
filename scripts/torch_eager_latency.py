"""Eager latency of the PyTorch port's main path, to compare two trees.

Builds, from the checkout at ``tree``, the model of chip_smoke.py's phase
4c: bench.py's compressed GPT-2 at full width (768 wide, 12 blocks, vocab
50257, batch 1, seq 64, eight head chunks; random weights and tokens from
fixed seeds) under its kernel configuration, and times the eager private
forward on the card: one warm-up, then ``--reps`` forwards, each between
``torch.cuda.synchronize()`` calls on the host clock. The eager forward is
bound by the host, so its latency moves between machines and runs: compare
two trees only within one session, run in the order parent, change,
change, parent.

    python3 scripts/torch_eager_latency.py <tree> [--reps 8]

Prints one JSON line: the tree, the card's name and power limit, every
latency, the best and the median.
"""

import argparse
import json
import os
import statistics
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("tree", help="root of a checkout holding chip_smoke.py and curl_tpu_torch/")
    ap.add_argument("--reps", type=int, default=8)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_eager_latency: needs a CUDA card")
    import chip_smoke as cs
    import curl_tpu_torch as ct
    from curl_tpu_torch.config import cfg
    from curl_tpu_torch.kernels import build
    from curl_tpu_torch.models import GPT, GPT2

    build.build_all()
    d, vocab, blocks = (GPT2.GEOM[k] for k in ("embed_dim", "vocab_size", "num_blocks"))
    sd = cs.random_gpt2_state(np.random.default_rng(1234), cs.SEQ, blocks, d=d, vocab=vocab)
    tokens = np.random.default_rng(0).integers(0, 1000, size=(1, cs.SEQ)).astype(np.float64)
    ct.init(world_size=2, seed=cs.SEED)
    with cfg.temp_override(cs.BENCH_CONFIG):
        model = GPT.build_compressed(**GPT2.GEOM, seq_len=cs.SEQ, head_vocab_chunks=cs.HEAD_CHUNKS,
                                     state_dict=sd)
        xe = ct.cryptensor(tokens, precision=0)
        model(xe)
        lat = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(xe)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
    print(json.dumps({"tree": tree, "card": cs.nvidia_smi_line(), "latencies_s": lat,
                      "best_s": min(lat), "median_s": statistics.median(lat)}))


if __name__ == "__main__":
    main()
