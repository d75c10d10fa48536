"""CPU readings behind chip_smoke.py's phase 14 bounds and round counts: the
private GPT-2 forward under each protocol layout (rss3, ttp2, tfp3,
active2).

    python3 scripts/torch_protocols_bound.py readings --layout rss3 --seed 11 [--blocks 12]
    python3 scripts/torch_protocols_bound.py count --layout rss3
    JAX_PLATFORMS=cpu python3 scripts/torch_protocols_bound.py tiny

``readings``: the port at GPT-2's width (768 wide, 12 heads, seq 64, batch
1) on phase 14's weights (``random_gpt2_state`` at numpy seed 1234, the
first ``--blocks`` blocks) and tokens (bench.py's draw, ids below 1000, so
the embedding table is cut to its first 1000 rows: the one-hot lookup reads
the same rows): the final-LayerNorm hidden state against the float64
forward after each block, and once more with the block whose absence the
plaintext forward feels least left out (``--fault``). One JSON line a block.

``count``: rounds and bytes of one whole forward (``model(xe)``: the
embedding at vocab 50257, ``--blocks`` blocks, the head and its vocab
softmax) under the layout. Rounds and bytes depend on shapes alone, never on values, so
the ring products run as zeros of their shape here (a CPU cannot afford the
full-vocab products exactly); one JSON line.

``tiny``: curl_tpu's tiny GPT (tests/test_torch_gpt.py's ``TINY``, batch 8,
tests/golden/torch_protocols_reference.npz's weights and tokens) through its
own ``compile_parties`` (six programs a forward, as the golden's) under
each layout it runs, and the port's, at
session seeds 5, 6 and 7: the hidden state's and logits' readings against
float64.

These are CPU runs, never device numbers: readings about 20 s a block a
layout on 3 cores, count about 2 minutes a layout, tiny about 15 minutes
(curl_tpu's compiles).
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import curl_tpu_torch as ct  # noqa: E402
from chip_smoke import (PROTOCOL_LAYOUTS, SEQ, gpt2_tokens, hidden_stats,  # noqa: E402
                        plain_gpt_forward, private_hidden, random_gpt2_state)
from curl_tpu_torch.config import cfg  # noqa: E402
from curl_tpu_torch.models import GPT, GPT2, load_numpy_state_dict  # noqa: E402

VOCAB_CUT = 1000


def _layout(name):
    config, parties = PROTOCOL_LAYOUTS[name]
    return config, parties


def readings(args):
    config, parties = _layout(args.layout)
    full = random_gpt2_state(np.random.default_rng(1234), SEQ, GPT2.GEOM["num_blocks"])
    sd = {k: v for k, v in full.items() if not k.startswith("fc.")
          and not any(k.startswith(f"blocks.{i}.") for i in range(args.blocks, 12))}
    sd["tok_embed.weight"] = full["tok_embed.weight"][:VOCAB_CUT]
    sd["fc.weight"] = np.zeros((VOCAB_CUT, 768))
    sd["fc.bias"] = np.zeros(VOCAB_CUT)
    tokens = gpt2_tokens()
    ids = tokens.astype(np.int64)
    ref = [plain_gpt_forward(sd, ids, 12, b + 1, "cpu", head=False)[0].numpy()
           for b in range(args.blocks)]
    skip_err = [hidden_stats(plain_gpt_forward(sd, ids, 12, args.blocks, "cpu", skip=j,
                                               head=False)[0].numpy(), ref[-1])["scale_free_l2"]
                for j in range(args.blocks)]
    fault_block = int(np.argmin(skip_err))
    with cfg.temp_override(config):
        ct.init(world_size=parties, seed=args.seed, device="cpu")
        geom = dict(embed_dim=768, num_heads=12, num_blocks=args.blocks, vocab_size=VOCAB_CUT,
                    seq_len=SEQ)
        model = load_numpy_state_dict(GPT(full=True, **geom), sd)
        model.encrypt(src=0)
        xe = ct.cryptensor(tokens, precision=0)
        t0 = time.time()
        h = model.embed(xe)
        for i, block in enumerate(model.blocks):
            h = block(h)
            st = hidden_stats(model.ln(h).get_plain_text(), ref[i])
            print(json.dumps(dict(layout=args.layout, seed=args.seed, blocks=i + 1,
                                  s=round(time.time() - t0, 1), **st)), flush=True)
        if not args.fault:
            return
        fault = hidden_stats(private_hidden(model, xe, skip=fault_block).get_plain_text(),
                             ref[-1])
    print(json.dumps(dict(layout=args.layout, seed=args.seed, blocks=args.blocks,
                          left_out=fault_block, plain_left_out=skip_err[fault_block], **fault)),
          flush=True)


def count(args):
    from curl_tpu_torch import ring

    config, parties = _layout(args.layout)

    def zeros(a, b):  # the product's shape, no arithmetic
        batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
        return torch.zeros(batch + (a.shape[-2], b.shape[-1]), dtype=torch.int64)

    ring._plain_matmul = zeros
    GPT2.GEOM = dict(GPT2.GEOM, num_blocks=args.blocks)
    sd = random_gpt2_state(np.random.default_rng(1234), SEQ, args.blocks)
    with cfg.temp_override(config):
        ct.init(world_size=parties, seed=11, device="cpu")
        model = load_numpy_state_dict(GPT2(seq_len=SEQ), sd)
        model.encrypt(src=0)
        xe = ct.cryptensor(gpt2_tokens(), precision=0)
        ct.reset_communication_stats()
        t0 = time.time()
        model(xe)
        stats = ct.get_communication_stats()
    print(json.dumps(dict(layout=args.layout, blocks=args.blocks, rounds=stats["rounds"],
                          bytes=stats["bytes"],
                          calls=stats["calls"], s=round(time.time() - t0, 1))), flush=True)


def tiny(args):
    import jax

    jax.config.update("jax_enable_x64", True)
    import curl_tpu
    import test_torch_protocols as T
    from curl_tpu import models as jmodels
    from test_torch_gpt import TINY, plain_forward
    from torch_protocols_reference import staged_forward

    g = T._golden()
    sd, tokens = T._gpt_state(g)
    hidden, logits, _ = plain_forward(sd, tokens, TINY["num_heads"], TINY["num_blocks"])
    plain = dict(hidden=hidden[-1], logits=logits)

    def show(pkg, layout, seed, outs):
        for stage, got in zip(("hidden", "logits"), outs):
            print(json.dumps(dict(pkg=pkg, layout=layout, seed=seed, stage=stage,
                                  **hidden_stats(got, plain[stage]))), flush=True)

    for layout in T.MODEL_LAYOUTS:
        for seed in (5, 6, 7):
            show("port", layout, seed, T.port_gpt(layout, sd, tokens, seed=seed)[0])
        if f"gpt/{layout}/raises" in g:
            continue
        ws = T.LAYOUTS[layout][2]
        with curl_tpu.cfg.temp_override(T.layout_config(layout)):
            curl_tpu.init(world_size=ws, seed=5)
            jm = jmodels.GPT(full=True, **TINY)
            jm.load_state_dict(sd)
            jm.encrypt(src=0)
            x = curl_tpu.cryptensor(tokens.astype(np.float64), precision=0)
            _, params = jm.functional()
            run = staged_forward(jm, ws)
            with curl_tpu.no_grad():
                for seed in (5, 6, 7):
                    outs = run(params, x.mpc, seed)
                    show("curl_tpu", layout, seed,
                         [np.asarray(curl_tpu.CrypTensor(o).get_plain_text()) for o in outs])


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("readings", "count", "tiny"))
    ap.add_argument("--layout", choices=("rss3", "ttp2", "tfp3", "active2"), default="rss3")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--blocks", type=int, default=12)
    ap.add_argument("--fault", action="store_true",
                    help="readings: also the private forward with a block left out")
    args = ap.parse_args()
    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "3")))
    globals()[args.what](args)
