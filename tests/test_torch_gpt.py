"""The port's slice as a whole: the private GPT forward against curl_tpu.

A tiny full GPT (the geometry of ``__graft_entry__.py``: embed 8, 2 heads,
vocab 32, seq 4; here 1 block and a batch of 8) runs in both packages on the
same plaintext weights (curl_tpu's ``state_dict()``, loaded into the port by
``load_numpy_state_dict``) and the same token ids. The decoded probabilities
must agree within atol 0.1 with each other and with a float64 plaintext
forward (the bound of tests/test_hf_gpt2.py); the decoded final-LayerNorm
hidden state and logits of both packages must lie within bounds of the
plaintext that a forward with a planted fault fails; the
rounds and bytes of one forward must equal curl_tpu's CommStats. Port
hygiene is checked here too.

Run as a script, it prints the readings behind the bounds (PERF.md,
"Hidden-state error bound"): those of the final-LayerNorm error that
chip_smoke.py holds the full GPT-2 forward to, and those of the tiny test:

    python tests/test_torch_gpt.py --bound [--blocks 12]
    python tests/test_torch_gpt.py --tiny [--weight-seeds 6]
"""

import math
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)  # both packages and chip_smoke's helpers, also as a script

import curl_tpu  # noqa: E402
from curl_tpu import comm as jcomm  # noqa: E402
from curl_tpu import models as jmodels  # noqa: E402

import curl_tpu_torch as ct  # noqa: E402
from curl_tpu_torch.models import GPT, load_numpy_state_dict  # noqa: E402


def _erf(x):
    return np.vectorize(math.erf)(x)


def plain_forward(sd, tokens, heads, blocks, skip=None):
    """float64 plaintext GPT forward, block ``skip`` left out: the
    final-LayerNorm hidden state after every block prefix (list), the
    logits and the output probabilities."""
    def ln(x, p):
        mu = x.mean(-1, keepdims=True)
        var = ((x - mu) ** 2).mean(-1, keepdims=True)
        return (x - mu) / np.sqrt(var + 1e-5) * sd[f"{p}.weight"] + sd[f"{p}.bias"]

    def lin(x, p):
        return x @ sd[f"{p}.weight"].T + sd[f"{p}.bias"]

    x = sd["tok_embed.weight"][tokens] + sd["pos_embed"][:, : tokens.shape[1]]
    b, t, d = x.shape
    hd = d // heads
    hidden = []
    for i in range(blocks):
        if i == skip:
            continue
        p = f"blocks.{i}"
        q, k, v = np.split(lin(ln(x, f"{p}.ln1"), f"{p}.attn.search"), 3, axis=-1)
        q, k, v = (z.reshape(b, t, heads, hd).transpose(0, 2, 1, 3) for z in (q, k, v))
        s = q @ k.transpose(0, 1, 3, 2) / math.sqrt(hd)
        e = np.exp(s - s.max(-1, keepdims=True))
        y = (e / e.sum(-1, keepdims=True)) @ v
        x = x + lin(y.transpose(0, 2, 1, 3).reshape(b, t, d), f"{p}.attn.proj")
        h = lin(ln(x, f"{p}.ln2"), f"{p}.ff.0")
        x = x + lin(0.5 * h * (1 + _erf(h / math.sqrt(2))), f"{p}.ff.2")
        hidden.append(ln(x, "ln"))
    logits = lin(ln(x, "ln"), "fc")
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return hidden, logits, e / e.sum(-1, keepdims=True)


# one block: curl_tpu's eager forward costs minutes on the CPU, most of it
# per-op dispatch and compilation, and a second block adds as much again
TINY = dict(embed_dim=8, num_heads=2, num_blocks=1, vocab_size=32, seq_len=4)
BATCH = 8
# Bounds against the float64 plaintext forward (chip_smoke.hidden_stats):
# the final-LayerNorm hidden state's relative L2 error left after one scale
# per row (the private inv_sqrt errs by one factor per row), and the logits'
# relative L2 error. `python tests/test_torch_gpt.py --tiny` prints the
# readings, sound and with each planted fault, over several weight and
# session seeds (PERF.md, "Hidden-state error bound").
TINY_BOUNDS = {"hidden": ("scale_free_l2", 0.1), "logits": ("rel_l2", 0.2)}
FAULTS = ("block_left_out", "proj_weight_transposed")


def _planted(sd, fault):
    """(state dict, block to leave out) of a forward with a planted fault."""
    if fault == "block_left_out":
        return sd, 0
    sd = dict(sd)
    sd["blocks.0.attn.proj.weight"] = sd["blocks.0.attn.proj.weight"].T.copy()
    return sd, None


def _staged_forward(model, embed, x):
    """GPT.forward at head_chunk_positions 0, stage by stage: the
    final-LayerNorm hidden state, the logits and the probabilities."""
    h = embed(x)
    for block in model.blocks:
        h = block(h)
    h = model.ln(h)
    logits = model.fc(h)
    return h, logits, model.softmax(logits)


def _port_forward(sd, tokens, skip=None, seed=5):
    """The port's tiny private forward on the plaintext ``sd``, block
    ``skip`` left out: decoded (hidden, logits, probs) and the CommStats."""
    ct.init(world_size=2, seed=seed, device="cpu")
    pm = load_numpy_state_dict(GPT(full=True, **TINY), sd)
    if skip is not None:
        pm.blocks = type(pm.blocks)(*[b for i, b in enumerate(pm.blocks) if i != skip])
    pm.encrypt(src=0)
    px = ct.cryptensor(tokens.astype(np.float64), precision=0)
    ct.reset_communication_stats()
    outs = _staged_forward(pm, pm.embed, px)
    stats = ct.get_communication_stats()
    return [o.get_plain_text() for o in outs], stats, pm


@pytest.fixture(scope="module")
def tiny_runs():
    return _tiny_runs()


def _tiny_runs():
    """One forward of each package on the same weights and tokens."""
    curl_tpu.init(world_size=2, seed=5)
    jm = jmodels.GPT(full=True, **TINY)
    sd = {k: np.asarray(v, dtype=np.float64) for k, v in jm.state_dict().items()}
    tokens = np.random.default_rng(3).integers(0, TINY["vocab_size"], size=(BATCH, TINY["seq_len"]))

    jm.encrypt(src=0)
    jx = curl_tpu.cryptensor(tokens.astype(np.float64), precision=0)

    def jembed(x):
        return jm.tok_embed(x) + jm._parameters["pos_embed"][:, : x.shape[1], :]

    jcomm.reset_communication_stats()
    with curl_tpu.no_grad():
        jouts = _staged_forward(jm, jembed, jx)
    jstats = jcomm.get_communication_stats()
    jhidden, jlogits, jprobs = (o.get_plain_text() for o in jouts)

    (phidden, plogits, pprobs), pstats, pm = _port_forward(sd, tokens)
    hidden, logits, ref = plain_forward(sd, tokens, TINY["num_heads"], TINY["num_blocks"])
    return dict(jprobs=jprobs, jstats=jstats, pprobs=pprobs, pstats=pstats, ref=ref, sd=sd,
                pm=pm, tokens=tokens,
                port=dict(hidden=phidden, logits=plogits),
                curl_tpu=dict(hidden=jhidden, logits=jlogits),
                plaintext=dict(hidden=hidden[-1], logits=logits))


def test_converter_installs_curl_tpu_state_dict(tiny_runs):
    sd, pm = tiny_runs["sd"], tiny_runs["pm"]
    assert list(pm.state_dict()) == list(sd)
    with pytest.raises(KeyError):
        load_numpy_state_dict(GPT(full=True, **TINY), {k: sd[k] for k in list(sd)[1:]})


def test_tiny_gpt_matches_plaintext(tiny_runs):
    got = tiny_runs["pprobs"]
    assert got.shape == (BATCH, TINY["seq_len"], TINY["vocab_size"])
    np.testing.assert_allclose(got, tiny_runs["ref"], atol=0.1)


def test_tiny_gpt_matches_curl_tpu(tiny_runs):
    np.testing.assert_allclose(tiny_runs["pprobs"], tiny_runs["jprobs"], atol=0.1)


@pytest.mark.parametrize("pkg", ["port", "curl_tpu"])
@pytest.mark.parametrize("stage", ["hidden", "logits"])
def test_tiny_gpt_hidden_state_and_logits_match_plaintext(tiny_runs, pkg, stage):
    """Both packages' decoded final-LN hidden state and logits lie within
    the same bounds of the float64 plaintext forward."""
    from chip_smoke import hidden_stats

    got = tiny_runs[pkg][stage]
    assert got.shape == tiny_runs["plaintext"][stage].shape
    stat, bound = TINY_BOUNDS[stage]
    assert hidden_stats(got, tiny_runs["plaintext"][stage])[stat] <= bound


@pytest.mark.parametrize("fault", FAULTS)
def test_tiny_gpt_planted_fault_fails_the_bound(tiny_runs, fault):
    """The hidden-state bound tells a wrong forward from a sound one."""
    from chip_smoke import hidden_stats

    sd, skip = _planted(tiny_runs["sd"], fault)
    (hidden, logits, _), _, _ = _port_forward(sd, tiny_runs["tokens"], skip=skip)
    for stage, got in (("hidden", hidden), ("logits", logits)):
        stat, bound = TINY_BOUNDS[stage]
        assert hidden_stats(got, tiny_runs["plaintext"][stage])[stat] > bound


@pytest.mark.parametrize("key", ["rounds", "bytes", "calls"])
def test_tiny_gpt_comm_stats_equal_curl_tpu(tiny_runs, key):
    assert tiny_runs["pstats"][key] == tiny_runs["jstats"][key]


# -- port hygiene -------------------------------------------------------------

def _fresh_python(code):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)


def test_port_imports_neither_jax_nor_curl_tpu():
    r = _fresh_python(
        "import sys, curl_tpu_torch, curl_tpu_torch.kernels.build, "
        "curl_tpu_torch.kernels.ring_mm, curl_tpu_torch.kernels.philox\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'curl_tpu'))\n"
        "print(bad)"
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]", r.stdout


def test_chip_smoke_imports_neither_jax_nor_curl_tpu():
    import ast

    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "curl_tpu"}, roots


def test_init_without_device_raises_without_cuda():
    r = _fresh_python(
        "import torch, curl_tpu_torch as ct\n"
        "if torch.cuda.is_available():\n    print('has-cuda')\n"
        "else:\n"
        "    try:\n        ct.init(world_size=2, seed=0)\n    except RuntimeError:\n"
        "        print('raised')\n"
    )
    assert r.returncode == 0, r.stderr
    if r.stdout.strip() == "has-cuda":
        pytest.skip("this host has a CUDA device")
    assert r.stdout.strip() == "raised"


# -- the hidden-state bound of chip_smoke.py ----------------------------------

def _bound_main(blocks):
    """Final-LayerNorm error statistics (max |err|, mean |err|, relative
    L2) vs float64 plaintext after 1..blocks blocks, at GPT-2 width (768,
    12 heads, seq 64), for curl_tpu and the port on the CPU, and the
    plaintext forward's relative L2 distance with each block left out. The
    vocabulary is cut to 1000 rows: the token ids are drawn below 1000 as
    bench.py draws them, and the one-hot lookup is exact whatever the table
    height."""
    from chip_smoke import SEED, SEQ, fmt_stats, hidden_stats, random_gpt2_state

    geom = dict(embed_dim=768, num_heads=12, num_blocks=blocks, vocab_size=1000, seq_len=SEQ)
    sd = random_gpt2_state(np.random.default_rng(1234), SEQ, blocks, vocab=1000)
    tokens = np.random.default_rng(0).integers(0, 1000, size=(1, SEQ))
    ref, _, _ = plain_forward(sd, tokens, 12, blocks)
    for j in range(blocks):
        left_out = plain_forward(sd, tokens, 12, blocks, skip=j)[0][-1]
        print(f"plaintext without block {j}: {fmt_stats(hidden_stats(left_out, ref[-1]))}",
              flush=True)

    def run(module, x, pkg):
        h = module.tok_embed(x) + module._parameters["pos_embed"] if pkg == "curl_tpu" \
            else module.embed(x)
        for i, block in enumerate(module.blocks):
            h = block(h)
            print(f"{pkg} final-LN after {i + 1} block(s): "
                  f"{fmt_stats(hidden_stats(module.ln(h).get_plain_text(), ref[i]))}", flush=True)

    curl_tpu.init(world_size=2, seed=SEED)
    jm = jmodels.GPT(full=True, **geom)
    jm.load_state_dict({k: v for k, v in sd.items()})
    jm.encrypt(src=0)
    with curl_tpu.no_grad():
        run(jm, curl_tpu.cryptensor(tokens.astype(np.float64), precision=0), "curl_tpu")

    ct.init(world_size=2, seed=SEED, device="cpu")
    pm = load_numpy_state_dict(GPT(full=True, **geom), sd)
    pm.encrypt(src=0)
    run(pm, ct.cryptensor(tokens.astype(np.float64), precision=0), "curl_tpu_torch")


def _tiny_main(weight_seeds):
    """The tiny GPT test's readings: both packages on the test's weights,
    then the port alone on ``weight_seeds`` numpy weight sets (chip_smoke's
    init distributions) with session seeds 5 and 6, sound and with each
    planted fault."""
    from chip_smoke import fmt_stats, hidden_stats, random_gpt2_state

    def show(label, outs, plain):
        for stage, got in zip(("hidden", "logits"), outs):
            print(f"{label} {stage}: {fmt_stats(hidden_stats(got, plain[stage]))}", flush=True)

    r = _tiny_runs()
    show("curl_tpu", (r["curl_tpu"]["hidden"], r["curl_tpu"]["logits"]), r["plaintext"])
    show("port", (r["port"]["hidden"], r["port"]["logits"]), r["plaintext"])
    print(f"probabilities max |err|: port {np.abs(r['pprobs'] - r['ref']).max():.5f}, "
          f"curl_tpu {np.abs(r['jprobs'] - r['ref']).max():.5f}, "
          f"between them {np.abs(r['pprobs'] - r['jprobs']).max():.5f}", flush=True)
    for fault in FAULTS:
        sd, skip = _planted(r["sd"], fault)
        show(f"port, {fault}", _port_forward(sd, r["tokens"], skip=skip)[0][:2], r["plaintext"])
    for w in range(weight_seeds):
        sd = random_gpt2_state(np.random.default_rng(w), TINY["seq_len"], TINY["num_blocks"],
                               d=TINY["embed_dim"], vocab=TINY["vocab_size"])
        hidden, logits, _ = plain_forward(sd, r["tokens"], TINY["num_heads"], TINY["num_blocks"])
        plain = dict(hidden=hidden[-1], logits=logits)
        for seed in (5, 6):
            show(f"port, weights {w}, session {seed}",
                 _port_forward(sd, r["tokens"], seed=seed)[0][:2], plain)
        for fault in FAULTS:
            fsd, skip = _planted(sd, fault)
            show(f"port, weights {w}, {fault}",
                 _port_forward(fsd, r["tokens"], skip=skip)[0][:2], plain)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--bound", action="store_true")
    ap.add_argument("--blocks", type=int, default=3)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--weight-seeds", type=int, default=6)
    args = ap.parse_args()
    if args.bound or args.tiny:
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    if args.bound:
        _bound_main(args.blocks)
    if args.tiny:
        _tiny_main(args.weight_seeds)
