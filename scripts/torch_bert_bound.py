"""CPU readings behind chip_smoke.py's phase 8 bound and round count:
BertLarge's depth and vocabulary (24 post-LN blocks, 16 heads, vocab
30522) at a reduced width, built as phase 8 builds it (materialized, party
0's encryption, weights from ``chip_smoke.random_gpt2_state`` at numpy
seed 4321, bench.py's kernel configuration with head_chunk_positions 64,
bench.py's tokens).

    python3 scripts/torch_bert_bound.py --width 64
    python3 scripts/torch_bert_bound.py --width 256

Prints one JSON line: the forward's rounds (independent of the width), the
last block's output's errors against the float64 forward
(``chip_smoke.hidden_stats``), the plaintext's scale-free error without
each block (the least-felt one named) and the private forward's without
that block (the planted fault). CPU runs, never device numbers.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import curl_tpu_torch as ct  # noqa: E402
from chip_smoke import (BENCH_CONFIG, SEED, SEQ, bert_hidden, hidden_stats,  # noqa: E402
                        random_gpt2_state)
from curl_tpu_torch.config import cfg  # noqa: E402
from curl_tpu_torch.models import Bert, load_numpy_state_dict, plain_bert_forward  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=24)
    args = ap.parse_args()
    d, heads, blocks, vocab = args.width, 16, args.blocks, 30522
    t0 = time.time()
    ct.init(world_size=2, seed=SEED, device="cpu")
    sd = random_gpt2_state(np.random.default_rng(4321), SEQ, blocks, d=d, vocab=vocab)
    model = load_numpy_state_dict(Bert(d, heads, blocks, vocab, SEQ, full=True), sd)
    model.encrypt(src=0)
    tokens = np.random.default_rng(0).integers(0, 1000, size=(1, SEQ)).astype(np.float64)
    ids = tokens.astype(np.int64)
    ref = plain_bert_forward(sd, ids, heads, blocks, "cpu", head=False)[0].numpy()
    skip = [hidden_stats(plain_bert_forward(sd, ids, heads, blocks, "cpu", skip=j,
                                            head=False)[0].numpy(), ref)["scale_free_l2"]
            for j in range(blocks)]
    j = int(np.argmin(skip))
    xe = ct.cryptensor(tokens, precision=0)
    with cfg.temp_override(dict(BENCH_CONFIG, **{"models.head_chunk_positions": SEQ})):
        ct.reset_communication_stats()
        model(xe)
        stats = ct.get_communication_stats()
        sound = hidden_stats(bert_hidden(model, xe).get_plain_text(), ref)
        fault = hidden_stats(bert_hidden(model, xe, skip=j).get_plain_text(), ref)
    print(json.dumps(dict(width=d, blocks=blocks, vocab=vocab, rounds=stats["rounds"],
                          bytes=stats["bytes"], sound=sound, plaintext_without_block=skip[j],
                          least_felt_block=j, plaintext_without_block_max=max(skip),
                          private_without_block=fault, seconds=round(time.time() - t0, 1))))


if __name__ == "__main__":
    main()
