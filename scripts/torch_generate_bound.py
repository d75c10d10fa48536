"""CPU readings behind chip_smoke.py's phase 7 bound and phase 4e's rows.

Runs the PyTorch port on the CPU (the kernels' plain versions) at a reduced
width, with chip_smoke's seeds, tokens and configuration, and prints one
JSON line of readings; these are CPU runs of the protocol's arithmetic,
never device numbers.

    python3 scripts/torch_generate_bound.py generate --width 128
    python3 scripts/torch_generate_bound.py batch8 --width 64

``generate``: phase 7's generation (a causal GPT, 12 blocks, vocab 1000,
60-token prompt, 4 tokens, bench.py's kernel configuration) run eagerly
step by step: each step's last-position logits against the float64
forward of the same buffer (the scale-free relative L2 error of
``chip_smoke.hidden_stats``), whether the choice is the argmax of the
revealed logits and its plaintext margin; then one private step on the
prompt without the block whose absence the plaintext feels least (the
planted fault). ``batch8``: phase 4e's forward (8 x 64 tokens, the head
and embedding over chunks of 64 positions, Beaver-masked): each row's
final-LayerNorm hidden state against float64, and the planted fault's.
A width-128 generation takes about two minutes on 4 cores.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import curl_tpu_torch as ct  # noqa: E402
from chip_smoke import (BENCH_CONFIG, GEN_TOKENS, PROMPT_LEN, SEED, SEQ,  # noqa: E402
                        hidden_stats, plain_gpt_forward, random_gpt2_state)
from curl_tpu_torch.config import cfg  # noqa: E402
from curl_tpu_torch.models import GPT, load_numpy_state_dict  # noqa: E402
from curl_tpu_torch.models import generate as gen  # noqa: E402

VOCAB = 1000


def without_block(model, j):
    """The model's blocks with block ``j`` left out, restored on exit."""
    class _Ctx:
        def __enter__(self):
            self.kept = list(model.blocks._modules.items())
            model.blocks._modules.pop(str(j))

        def __exit__(self, *exc):
            model.blocks._modules.clear()
            model.blocks._modules.update(self.kept)

    return _Ctx()


def run_generate(sd, d, heads, blocks):
    model = load_numpy_state_dict(GPT(d, heads, blocks, VOCAB, SEQ, causal=True), sd)
    model.encrypt(src=0)
    params = model.params_pytree()
    prompt = np.random.default_rng(0).integers(0, 1000, size=(PROMPT_LEN,))
    buf0 = np.zeros((1, SEQ, VOCAB))
    buf0[0, np.arange(PROMPT_LEN), prompt] = 1.0
    sel, wr = gen.make_masks(PROMPT_LEN, GEN_TOKENS, SEQ)
    ref0 = gen.plaintext_logits(sd, buf0, heads)[0, PROMPT_LEN - 1]
    skip = [hidden_stats(gen.plaintext_logits(sd, buf0, heads, skip=j)[0, PROMPT_LEN - 1],
                         ref0)["scale_free_l2"] for j in range(blocks)]
    j = int(np.argmin(skip))
    steps = []
    with cfg.temp_override(BENCH_CONFIG):
        model.bind_params(params)
        model.premask_for_reuse()
        buf = ct.cryptensor(buf0)
        for g in range(GEN_TOKENS):
            ref = gen.plaintext_logits(sd, np.round(buf.get_plain_text()), heads)
            ref = ref[0, PROMPT_LEN + g - 1]
            buf, last = gen.decode_step(model, buf, sel[g], wr[g])
            got = last.get_plain_text()[0]
            tok = int(buf.get_plain_text()[0, PROMPT_LEN + g].argmax())
            steps.append(dict(scale_free_l2=hidden_stats(got, ref)["scale_free_l2"],
                              argmax_of_revealed=tok == int(got.argmax()),
                              plaintext_margin=float(ref.max() - ref[tok])))
        with without_block(model, j):
            model.bind_params(params)
            model.premask_for_reuse()
            _, last = gen.decode_step(model, ct.cryptensor(buf0), sel[0], wr[0])
        fault = hidden_stats(last.get_plain_text()[0], ref0)["scale_free_l2"]
    return dict(steps=steps, skip_min=skip[j], skip_block=j, fault=fault)


def run_batch8(sd, d, heads, blocks):
    model = load_numpy_state_dict(GPT(d, heads, blocks, VOCAB, SEQ), sd).encrypt(src=0)
    tokens = np.random.default_rng(0).integers(0, 1000, size=(8, SEQ)).astype(np.float64)
    ids = tokens.astype(np.int64)
    ref = plain_gpt_forward(sd, ids, heads, blocks, "cpu", head=False)[0].numpy()
    skip = [hidden_stats(plain_gpt_forward(sd, ids, heads, blocks, "cpu", skip=j,
                                           head=False)[0].numpy(), ref)["scale_free_l2"]
            for j in range(blocks)]
    j = int(np.argmin(skip))
    apply_fn, params = model.functional()

    def hidden():
        seen = []
        hook = model.ln.register_forward_hook(lambda mod, inp, out: seen.append(out))
        try:
            apply_fn(params, ct.cryptensor(tokens, precision=0))
        finally:
            hook.remove()
        return np.concatenate([h.get_plain_text().reshape(-1, d) for h in seen]).reshape(8, SEQ, d)

    with cfg.temp_override(dict(BENCH_CONFIG, **{"models.head_chunk_positions": SEQ})):
        sound = hidden()
        with without_block(model, j):
            fault = hidden()
    return dict(rows=[hidden_stats(sound[i], ref[i])["scale_free_l2"] for i in range(8)],
                fault_rows=[hidden_stats(fault[i], ref[i])["scale_free_l2"] for i in range(8)],
                fault=hidden_stats(fault, ref)["scale_free_l2"], skip_min=skip[j], skip_block=j)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("generate", "batch8"))
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=12)
    args = ap.parse_args()
    d, blocks = args.width, args.blocks
    heads = max(1, d // 64)
    torch.set_num_threads(4)
    ct.init(world_size=2, seed=SEED, device="cpu")
    sd = random_gpt2_state(np.random.default_rng(1234), SEQ, blocks, d=d, vocab=VOCAB)
    t0 = time.perf_counter()
    out = (run_generate if args.mode == "generate" else run_batch8)(sd, d, heads, blocks)
    print(json.dumps(dict(mode=args.mode, width=d, blocks=blocks, vocab=VOCAB, device="cpu",
                          seconds=time.perf_counter() - t0, **out)))


if __name__ == "__main__":
    main()
