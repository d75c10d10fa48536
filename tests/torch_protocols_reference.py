"""curl_tpu's readings under every protocol layout that
tests/test_torch_protocols.py holds the port to, where running curl_tpu in
the test would take too long (its sweep of 13 ops over six layouts takes
several minutes eagerly; its tiny GPT at 3 parties does not finish eagerly
in 600 s on a CPU, so it runs here through curl_tpu's own
``compile_parties``, six jitted programs a forward: ``staged_forward``).

    JAX_PLATFORMS=cpu python3 tests/torch_protocols_reference.py \
        [sweep] [provider] [forms] [gpt]

writes ``tests/golden/torch_protocols_reference.npz`` (naming parts rewrites
only theirs): for each (layout, op) of the test's sweep, each of its
provider cases and each tuple form its knobs force, curl_tpu's decoded
output and its rounds, bytes and calls by collective; for the tiny GPT
(tests/test_torch_gpt.py's ``TINY``, batch 8) the state dict and tokens
both packages read, and under each of the test's ``MODEL_LAYOUTS``
curl_tpu's decoded final-LayerNorm hidden state and logits with the
forward's CommStats, or, where curl_tpu raises (its active security on a
matmul), the error it raises. Run from the repo's root.
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

GOLDEN = os.path.join(ROOT, "tests", "golden", "torch_protocols_reference.npz")
PARTS = ("sweep", "provider", "forms", "gpt")


def _put(out, key, decoded, stats):
    out[f"{key}/output"] = np.asarray(decoded, dtype=np.float64)
    out[f"{key}/counts"] = np.array([stats["rounds"], stats["bytes"]])
    names = sorted(stats["calls"])
    out[f"{key}/call_names"] = np.array(names)
    out[f"{key}/call_counts"] = np.array([stats["calls"][n] for n in names], dtype=np.int64)
    print(key, stats["rounds"], stats["bytes"], flush=True)


def sweep(out):
    import test_torch_protocols as T

    for layout in T.SWEEP:
        for name, (inputs, op, *_) in T.OPS.items():
            _put(out, f"sweep/{layout}/{name}", *T.run_case("curl_tpu", layout, inputs, op))


def provider(out):
    import test_torch_protocols as T

    for case, (layout, inputs, op, *_) in sorted(T.PROVIDER_CASES.items()):
        _put(out, f"provider/{case}", *T.run_case("curl_tpu", layout, inputs, op, seed=1234))


def forms(out):
    import test_torch_protocols as T

    for case, (config, inputs, precisions, op, *_) in sorted(T.FORM_CASES.items()):
        _put(out, f"forms/{case}", *T.run_case("curl_tpu", "tfp2", inputs, op, config=config,
                                               precisions=precisions))


def gpt(out):
    import curl_tpu
    import test_torch_protocols as T
    from curl_tpu import comm as jcomm
    from curl_tpu import models as jmodels
    from test_torch_gpt import BATCH, TINY

    curl_tpu.init(world_size=2, seed=5)
    sd = {k: np.asarray(v, dtype=np.float64)
          for k, v in jmodels.GPT(full=True, **TINY).state_dict().items()}
    tokens = np.random.default_rng(3).integers(0, TINY["vocab_size"], size=(BATCH, TINY["seq_len"]))
    for k, v in sd.items():
        out[f"gpt/sd/{k}"] = v
    out["gpt/tokens"] = tokens
    for layout in T.MODEL_LAYOUTS:
        ws = T.LAYOUTS[layout][2]
        with curl_tpu.cfg.temp_override(T.layout_config(layout)):
            curl_tpu.init(world_size=ws, seed=5)
            jm = jmodels.GPT(full=True, **TINY)
            jm.load_state_dict(sd)
            jm.encrypt(src=0)
            x = curl_tpu.cryptensor(tokens.astype(np.float64), precision=0)
            _, params = jm.functional()
            jcomm.reset_communication_stats()
            try:
                with curl_tpu.no_grad():
                    h, logits = staged_forward(jm, ws)(params, x.mpc)
            except Exception as e:  # curl_tpu's active security on a matmul
                out[f"gpt/{layout}/raises"] = np.array(f"{type(e).__name__}: {e}"[:200])
                print(layout, "raises", type(e).__name__, str(e)[:200], flush=True)
                continue
            stats = jcomm.get_communication_stats()
        _put(out, f"gpt/{layout}/hidden", curl_tpu.CrypTensor(h).get_plain_text(), stats)
        out[f"gpt/{layout}/logits"] = np.asarray(curl_tpu.CrypTensor(logits).get_plain_text())


def staged_forward(jm, ws):
    """curl_tpu's tiny GPT (one block) as six programs of its own
    ``compile_parties``, each jitted over the ``ws`` parties: the embedding,
    ln1, the attention and its residual, ln2, the MLP and its residual,
    the final LayerNorm with the head. Six small programs compile in
    minutes where the whole forward at 3 parties does not; the CommStats of
    each are counted at its trace and add up to the forward's. Returns
    ``run(params, x, seed)`` -> (the final-LayerNorm hidden state, the
    logits), stacked; the programs compile at the first call."""
    import jax

    from curl_tpu.parallel import compile_parties

    (block,) = jm.blocks

    def head(h):
        h = jm.ln(h)
        return h, jm.fc(h)

    stages = [
        lambda xs: jm.tok_embed(xs) + jm._parameters["pos_embed"][:, : xs.shape[1], :],
        lambda h: (h, block.ln1(h)),
        lambda h, a: h + block.attn(a),
        lambda h: (h, block.ln2(h)),
        lambda h, a: h + block.ff(a),
        head,
    ]

    def bound(fn):
        def stage(p, *xs):
            jm.bind_params(p)
            return fn(*xs)
        return stage

    programs = [compile_parties(bound(fn), ws) for fn in stages]

    def run(params, x, seed=5):
        vals = (x,)
        for i, program in enumerate(programs):
            vals = program(jax.random.PRNGKey(seed + 100 * i), params, *vals)
            vals = vals if isinstance(vals, tuple) else (vals,)
        return vals

    return run


def main(parts):
    import jax

    jax.config.update("jax_enable_x64", True)
    out = {}
    for part in parts:
        globals()[part](out)
    if os.path.exists(GOLDEN):  # the other parts' readings, as the file holds them now
        with np.load(GOLDEN) as f:
            out.update({k: f[k] for k in f.files if k.split("/")[0] not in parts})
    np.savez_compressed(GOLDEN, **out)


if __name__ == "__main__":
    main([p for p in sys.argv[1:] if p in PARTS] or list(PARTS))
