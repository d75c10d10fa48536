"""CPU readings behind chip_smoke.py's phase 4f bound and round count:
GPT-Neo 2.7B's depth and vocabulary (32 blocks, 20 heads, vocab 50257) at
a reduced width, built as phase 4f builds it (``GPT.build_compressed`` with
chunked block linears, 8 vocab chunks, weights from
``chip_smoke.SeededGPTState``, bench.py's kernel configuration with
head_chunk_positions 64, bench.py's tokens).

    python3 scripts/torch_neo_large_bound.py --width 80
    python3 scripts/torch_neo_large_bound.py --width 240
    python3 scripts/torch_neo_large_bound.py --width 480
    python3 scripts/torch_neo_large_bound.py --width 240 --seed 1

(widths that 20 heads divide, beside the 64 and 256 of GPT-Neo's bound;
``--seed`` sets the session's seed, which draws every share and mask, in
place of phase 4f's; the weights and tokens stay phase 4f's).
``--model GPTNeo`` reads GPT-Neo 1.3B's geometry the same way. The
rounds depend on the width only through the attention's scale: a head
dimension whose square root is an integer divides locally, any other
multiplies by 1/sqrt(d) and truncates (one round a block), so the width
must give the full model's kind of head dimension (240: 12, as 2560: 128).

Prints one JSON line: the forward's rounds (independent of the width), the
final-LayerNorm hidden state's errors against the float64 forward
(``chip_smoke.hidden_stats``), the plaintext forward's scale-free error
without each block (the least-felt one named), and the private forward's
without that block (the planted fault). CPU runs of the protocol's
arithmetic, never device numbers.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import curl_tpu_torch as ct  # noqa: E402
from chip_smoke import (BENCH_CONFIG, HEAD_CHUNKS, SEED, SEQ, SeededGPTState,  # noqa: E402
                        hidden_stats, plain_gpt_forward, private_hidden)
from curl_tpu_torch.config import cfg  # noqa: E402
from curl_tpu_torch import models  # noqa: E402
from curl_tpu_torch.models import GPT  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=80)
    ap.add_argument("--model", default="GPTNeoLarge", help="a GEOM of curl_tpu_torch.models")
    ap.add_argument("--blocks", type=int, default=None)
    ap.add_argument("--seed", type=int, default=SEED)
    args = ap.parse_args()
    geom = dict(getattr(models, args.model).GEOM, embed_dim=args.width)
    if args.blocks is not None:
        geom["num_blocks"] = args.blocks
    d, heads, blocks, vocab = (geom[k] for k in ("embed_dim", "num_heads", "num_blocks",
                                                 "vocab_size"))
    t0 = time.time()
    sd = SeededGPTState(1234, SEQ, blocks, d, vocab)
    tokens = np.random.default_rng(0).integers(0, 1000, size=(1, SEQ)).astype(np.float64)
    ids = tokens.astype(np.int64)
    W = {k: np.asarray(v) for k, v in sd.items()}
    ref = plain_gpt_forward(W, ids, heads, blocks, "cpu", head=False)[0].numpy()
    skip = [hidden_stats(plain_gpt_forward(W, ids, heads, blocks, "cpu", skip=j,
                                           head=False)[0].numpy(), ref)["scale_free_l2"]
            for j in range(blocks)]
    j = int(np.argmin(skip))
    ct.init(world_size=2, seed=args.seed, device="cpu")
    with cfg.temp_override(dict(BENCH_CONFIG, **{"models.head_chunk_positions": SEQ})):
        model = GPT.build_compressed(**geom, seq_len=SEQ, head_vocab_chunks=HEAD_CHUNKS,
                                     chunk_block_linears=True, state_dict=W)
        xe = ct.cryptensor(tokens, precision=0)
        ct.reset_communication_stats()
        model(xe)
        stats = ct.get_communication_stats()
        sound = hidden_stats(private_hidden(model, xe).get_plain_text(), ref)
        fault = hidden_stats(private_hidden(model, xe, skip=j).get_plain_text(), ref)
    print(json.dumps(dict(width=d, seed=args.seed, blocks=blocks, vocab=vocab, rounds=stats["rounds"],
                          bytes=stats["bytes"], sound=sound, plaintext_without_block=skip[j],
                          least_felt_block=j, plaintext_without_block_max=max(skip),
                          private_without_block=fault, seconds=round(time.time() - t0, 1))))


if __name__ == "__main__":
    main()
