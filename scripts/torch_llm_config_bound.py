"""CPU readings behind chip_smoke.py's phase 15b: phase 4's materialized
GPT-2 under the port's ``configs/llm_config.yaml`` (``init(config_file=)``,
as examples/llms.py --no_cmp runs it).

    python3 scripts/torch_llm_config_bound.py count [--blocks 12]
    python3 scripts/torch_llm_config_bound.py readings --seed 11 [--blocks 12] [--fault]

``count``: rounds, bytes and calls of one whole forward (``model(xe)``: the
embedding at vocab 50257, ``--blocks`` blocks, the head and its vocab
softmax), phase 15b's counts. They depend on shapes alone, never on values,
so the ring products run as zeros of their shape here (a CPU cannot afford
the full-vocab products exactly); one JSON line.

``readings``: the port at GPT-2's width (768 wide, 12 heads, seq 64, batch
1) on phase 4's weights (``random_gpt2_state`` at numpy seed 1234) and
tokens (bench.py's draw, ids below 1000, so the embedding table is cut to
its first 1000 rows: the one-hot lookup reads the same rows): the
final-LayerNorm hidden state against the float64 forward after each block,
with the share of LayerNorm rows whose variance + eps lies outside
llm_config's inv_sqrt table domain [0, 2^inv_sqrt_lut_max_bits) in the
float64 forward; ``--fault``: once more with the block whose absence the
plaintext forward feels least left out. One JSON line a block.

These are CPU runs, never device numbers: count about 2 minutes, readings
about 20 s a block on 3 cores.
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

import curl_tpu_torch as ct  # noqa: E402
from chip_smoke import (SEQ, gpt2_tokens, hidden_stats, plain_gpt_forward,  # noqa: E402
                        private_hidden, random_gpt2_state)
from curl_tpu_torch.config import cfg, profile  # noqa: E402
from curl_tpu_torch.models import GPT, GPT2, load_numpy_state_dict  # noqa: E402

VOCAB_CUT = 1000
PROFILE = profile("llm_config")


def _ln_inputs_outside(sd, ids, blocks):
    """The share of the float64 forward's LayerNorm rows (every block's two
    and the final one) whose variance + eps lies outside the profile's
    inv_sqrt table domain."""
    W = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in sd.items()}
    top = 2.0 ** cfg.functions.inv_sqrt_lut_max_bits
    x = W["tok_embed.weight"][torch.as_tensor(ids)] + W["pos_embed"][:, : ids.shape[1]]
    outside, rows = 0, 0

    def ln(x, p):
        nonlocal outside, rows
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        outside += int(((var + 1e-5) >= top).sum())
        rows += var.numel()
        return (x - mu) / torch.sqrt(var + 1e-5) * W[f"{p}.weight"] + W[f"{p}.bias"]

    def lin(x, p):
        return x @ W[f"{p}.weight"].T + W[f"{p}.bias"]

    b, t, d = x.shape
    hd = d // 12
    for i in range(blocks):
        p = f"blocks.{i}"
        q, k, v = lin(ln(x, f"{p}.ln1"), f"{p}.attn.search").split(d, dim=-1)
        q, k, v = (z.reshape(b, t, 12, hd).transpose(1, 2) for z in (q, k, v))
        att = torch.softmax(q @ k.transpose(-1, -2) / np.sqrt(hd), dim=-1)
        x = x + lin((att @ v).transpose(1, 2).reshape(b, t, d), f"{p}.attn.proj")
        h = lin(ln(x, f"{p}.ln2"), f"{p}.ff.0")
        x = x + lin(0.5 * h * (1 + torch.erf(h / np.sqrt(2))), f"{p}.ff.2")
    ln(x, "ln")
    return outside / rows


def readings(args):
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
    ct.init(config_file=PROFILE, world_size=2, seed=args.seed, device="cpu")
    try:
        outside = _ln_inputs_outside(sd, ids, args.blocks)
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
            print(json.dumps(dict(seed=args.seed, blocks=i + 1, s=round(time.time() - t0, 1),
                                  ln_rows_outside_inv_sqrt_domain=outside, **st)), flush=True)
        if args.fault:
            fault = hidden_stats(private_hidden(model, xe, skip=fault_block).get_plain_text(),
                                 ref[-1])
            print(json.dumps(dict(seed=args.seed, blocks=args.blocks, left_out=fault_block,
                                  plain_left_out=skip_err[fault_block], **fault)), flush=True)
    finally:
        cfg.load_config(None)


def count(args):
    from curl_tpu_torch import ring

    def zeros(a, b):  # the product's shape, no arithmetic
        batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
        return torch.zeros(batch + (a.shape[-2], b.shape[-1]), dtype=torch.int64)

    ring._plain_matmul = zeros
    GPT2.GEOM = dict(GPT2.GEOM, num_blocks=args.blocks)
    sd = random_gpt2_state(np.random.default_rng(1234), SEQ, args.blocks)
    ct.init(config_file=PROFILE, world_size=2, seed=11, device="cpu")
    try:
        model = load_numpy_state_dict(GPT2(seq_len=SEQ), sd)
        model.encrypt(src=0)
        xe = ct.cryptensor(gpt2_tokens(), precision=0)
        ct.reset_communication_stats()
        t0 = time.time()
        model(xe)
        stats = ct.get_communication_stats()
    finally:
        cfg.load_config(None)
    print(json.dumps(dict(blocks=args.blocks, rounds=stats["rounds"], bytes=stats["bytes"],
                          calls=stats["calls"], s=round(time.time() - t0, 1))), flush=True)


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("what", choices=("count", "readings"))
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("--blocks", type=int, default=12)
    p.add_argument("--fault", action="store_true")
    args = p.parse_args()
    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "3")))
    {"count": count, "readings": readings}[args.what](args)


if __name__ == "__main__":
    main()
