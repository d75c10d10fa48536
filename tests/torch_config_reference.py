"""curl_tpu's readings under its two partial profiles that
tests/test_torch_config.py holds the port to:

  * under ``configs/llm_config.yaml`` and ``configs/approximations.yaml``
    (``curl_tpu.init(config_file=...)``), the decoded outputs of the eight
    functions of ROADMAP's re-anchor probe (gelu, reciprocal, inv_sqrt, log,
    sqrt, erf, exp, silu) at the test's 64 points in [0.05, 4] at session
    seed 3, and each function's worst max |error| over session seeds 3 to
    10 (PR 10's rule takes curl_tpu's worst over draws: a coarse table's
    cell can slip by one at its edges under EGK's rounding);
  * under llm_config, the tiny GPT of tests/test_torch_gpt.py (embed 8, 2
    heads, 1 block, vocab 32, seq 4, batch 8): its state dict and tokens,
    which both packages read, and one forward's decoded final-LayerNorm
    hidden state, logits and CommStats. llm_config takes the
    scan_reduction max, whose stages curl_tpu runs under ``lax.scan`` and
    counts once a body; here its scans are unrolled, so that every step
    counts, as the port counts them (ROADMAP Queue C). curl_tpu's eager
    forward takes minutes on a CPU, so the test does not run it.

    JAX_PLATFORMS=cpu python3 tests/torch_config_reference.py

writes ``tests/golden/torch_config_reference.npz``. Run from the repo's root.
"""

import contextlib
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

GOLDEN = os.path.join(ROOT, "tests", "golden", "torch_config_reference.npz")


def _unrolled_scan(f, init, xs, length=None):
    """``jax.lax.scan`` as a Python loop: each step traced, and counted, on
    its own."""
    import jax
    import jax.numpy as jnp

    n = length if xs is None else jax.tree_util.tree_leaves(xs)[0].shape[0]
    carry, ys = init, []
    for i in range(n):
        carry, y = f(carry, None if xs is None else jax.tree_util.tree_map(lambda a: a[i], xs))
        ys.append(y)
    if not ys or ys[0] is None:
        return carry, None
    return carry, jax.tree_util.tree_map(lambda *a: jnp.stack(a), *ys)


@contextlib.contextmanager
def unrolled_scans():
    """curl_tpu's forward with every ``lax.scan`` unrolled (its
    scan_reduction stages import ``lax`` where they run)."""
    import jax

    saved = jax.lax.scan
    jax.lax.scan = _unrolled_scan
    try:
        yield
    finally:
        jax.lax.scan = saved


def main():
    import curl_tpu
    from curl_tpu import comm as jcomm
    from curl_tpu import models as jmodels

    import test_torch_config as T

    configs = os.path.join(os.path.dirname(curl_tpu.__file__), "configs")
    out = {"points": T.POINTS}
    for profile in T.PROFILES:
        worst = dict.fromkeys(T.FUNCTIONS, 0.0)
        for seed in T.WORST_SEEDS:
            curl_tpu.init(config_file=os.path.join(configs, f"{profile}.yaml"), world_size=2,
                          seed=seed)
            xe = curl_tpu.cryptensor(T.POINTS)
            for name in T.FUNCTIONS:
                got = np.asarray(getattr(xe, name)().get_plain_text(), dtype=np.float64)
                if seed == T.SESSION_SEED:
                    out[f"{profile}/{name}"] = got
                err = float(np.abs(got - T.plain(name, T.POINTS)).max())
                worst[name] = max(worst[name], err)
                print(profile, seed, name, f"max |error| {err:.6g}", flush=True)
        for name in T.FUNCTIONS:
            out[f"{profile}/{name}/worst"] = np.array(worst[name])

    curl_tpu.init(config_file=os.path.join(configs, "llm_config.yaml"), world_size=2,
                  seed=T.GPT_SEED)
    jm = jmodels.GPT(full=True, **T.TINY)
    sd = {k: np.asarray(v, dtype=np.float64) for k, v in jm.state_dict().items()}
    tokens = T.tiny_tokens()
    jm.encrypt(src=0)
    jx = curl_tpu.cryptensor(tokens.astype(np.float64), precision=0)

    def embed(x):
        return jm.tok_embed(x) + jm._parameters["pos_embed"][:, : x.shape[1], :]

    jcomm.reset_communication_stats()
    with curl_tpu.no_grad(), unrolled_scans():
        hidden, logits = T.staged_forward(jm, embed, jx)
    stats = jcomm.get_communication_stats()
    for k, v in sd.items():
        out[f"gpt/sd/{k}"] = v
    out["gpt/tokens"] = tokens
    out["gpt/hidden"] = np.asarray(hidden.get_plain_text(), dtype=np.float64)
    out["gpt/logits"] = np.asarray(logits.get_plain_text(), dtype=np.float64)
    out["gpt/counts"] = np.array([stats["rounds"], stats["bytes"]])
    names = sorted(stats["calls"])
    out["gpt/call_names"] = np.array(names)
    out["gpt/call_counts"] = np.array([stats["calls"][n] for n in names], dtype=np.int64)
    print("tiny gpt under llm_config", stats["rounds"], stats["bytes"], flush=True)
    curl_tpu.cfg.load_config(None)
    np.savez(GOLDEN, **out)
    print("wrote", GOLDEN)


if __name__ == "__main__":
    main()
