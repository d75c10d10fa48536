"""The port's private generation (``models/generate.py``, counterpart of
``examples/generate.py``) and ``load_hf_state_dict`` against curl_tpu's, on
the CPU.

curl_tpu's tiny generator did not finish compiling in 500 s on a CPU, so
its rounds and bytes are counted at trace (``jax.make_jaxpr``, parameters
as zero shares of the right shapes), and the port's tokens are held to the
JAX repo's own float64 replica (``examples/generate.py``
``plaintext_replica``, pure numpy). The private equality, argmax and the
causal softmax the loop runs are held to curl_tpu in
tests/test_torch_argmax.py.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import curl_tpu  # noqa: E402
from curl_tpu import comm as jcomm  # noqa: E402
from curl_tpu import models as jmodels  # noqa: E402
from curl_tpu.mpc.mpc import MPCTensor as JMPCTensor  # noqa: E402
from curl_tpu.parallel import compile_parties as jcompile  # noqa: E402

import examples.generate as jgenerate  # noqa: E402

import curl_tpu_torch as ct  # noqa: E402
from curl_tpu_torch import parallel  # noqa: E402
from curl_tpu_torch import random as trng  # noqa: E402
from curl_tpu_torch.models import GPT, load_hf_state_dict, load_numpy_state_dict  # noqa: E402
from curl_tpu_torch.models import generate  # noqa: E402
from curl_tpu_torch.mpc.primitives import beaver  # noqa: E402

# tests/test_generate.py's geometry
TINY = dict(seq_len=6, vocab=31, dim=16, heads=2, blocks=1, prompt_len=3, gen_tokens=2, seed=0)


def _zero_shares(tree):
    """A plaintext parameter pytree as MPCTensors of zero shares (2
    parties): what curl_tpu's trace needs, without its eager encryption."""
    return jax.tree_util.tree_map(
        lambda p: JMPCTensor.from_shares(jnp.zeros((2,) + tuple(np.shape(p)), jnp.uint64)), tree)


def _jax_counts(fn, ws, *args):
    """curl_tpu's rounds, bytes and calls of ``fn`` on MPCTensor
    arguments, counted at trace."""
    jcomm.reset_communication_stats()
    jax.make_jaxpr(jcompile(fn, ws))(jax.random.PRNGKey(5), *args)
    s = jcomm.get_communication_stats()
    return s["rounds"], s["bytes"], dict(s["calls"])


def _jax_enc(ws, *values):
    curl_tpu.init(world_size=ws, seed=1234)
    return [curl_tpu.cryptensor(v).mpc for v in values]


# -- the decode loop ------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """curl_tpu's tiny causal GPT as examples/generate.py's run() builds it
    (scaled weights, its own embedding and positions), its state dict, the
    prompt buffer, and the JAX repo's plaintext replica's tokens."""
    p = TINY
    curl_tpu.init(world_size=2, seed=p["seed"])
    model = jmodels.GPT(embed_dim=p["dim"], num_heads=p["heads"], num_blocks=p["blocks"],
                        vocab_size=p["vocab"], seq_len=p["seq_len"], full=True, causal=True)
    rng = np.random.default_rng(p["seed"])
    for mod in model.modules():
        for name, w in list(mod._parameters.items()):
            mod._parameters[name] = jnp.asarray(np.asarray(w) * 0.25)
    model.tok_embed._parameters["weight"] = jnp.asarray(rng.normal(size=(p["vocab"], p["dim"])) * 0.5)
    model._parameters["pos_embed"] = jnp.asarray(rng.normal(size=(1, p["seq_len"], p["dim"])) * 0.1)
    sd = {k: np.asarray(v) for k, v in model.state_dict().items()}
    prompt = rng.integers(0, p["vocab"], size=(p["prompt_len"],))
    buf0 = np.zeros((1, p["seq_len"], p["vocab"]))
    buf0[0, np.arange(p["prompt_len"]), prompt] = 1.0
    want, fwd = jgenerate.plaintext_replica(jgenerate.extract_plain_weights(model), buf0,
                                            p["prompt_len"], p["gen_tokens"], p["heads"])
    return dict(model=model, sd=sd, buf0=buf0, want=want, fwd=fwd)


def _port_generator(tiny, steps=None, seed=None):
    p = TINY
    ct.init(world_size=2, seed=p["seed"] if seed is None else seed, device="cpu")
    model = load_numpy_state_dict(
        GPT(p["dim"], p["heads"], p["blocks"], p["vocab"], p["seq_len"], causal=True), tiny["sd"])
    model.encrypt(src=0)
    params = model.params_pytree()
    forward = generate.build_generator(model, p["prompt_len"], steps or p["gen_tokens"])

    def run(prm, buf):
        # the plain shares bound on every call: each call masks anew
        model.bind_params(prm)
        return forward(buf), model.fc.weight._tensor.delta[:2]

    return model, params, forward, run


def test_tiny_generation_matches_the_plaintext_replica(tiny):
    """tests/test_generate.py's check: every encrypted choice a
    near-argmax of the plaintext logits (margin below 0.05), and the
    tokens equal the JAX repo's float64 replica's."""
    p = TINY
    model, params, _, run = _port_generator(tiny)
    buf, _ = parallel.compile_parties(run, 2)(p["seed"] + 1, params, ct.cryptensor(tiny["buf0"]))
    final = buf.get_plain_text()
    got = [int(final[0, p["prompt_len"] + g].argmax()) for g in range(p["gen_tokens"])]
    margins, chk = [], tiny["buf0"].copy()
    for g, tok in enumerate(got):
        logits = tiny["fwd"](chk)[0, p["prompt_len"] + g - 1]
        margins.append(float(logits.max() - logits[tok]))
        chk[0, p["prompt_len"] + g, tok] = 1.0
    assert max(margins) < 0.05, margins
    assert got == tiny["want"], (got, tiny["want"], margins)
    mine, fwd = generate.plaintext_replica(tiny["sd"], tiny["buf0"], p["prompt_len"],
                                           p["gen_tokens"], p["heads"])
    assert mine == tiny["want"]
    np.testing.assert_allclose(fwd(tiny["buf0"]), tiny["fwd"](tiny["buf0"]), atol=1e-12)
    # every written row a one-hot
    rows = final[0, p["prompt_len"]:p["prompt_len"] + p["gen_tokens"]]
    np.testing.assert_allclose(np.sort(rows, -1)[:, -1], 1.0, atol=2.0 ** -12)
    np.testing.assert_allclose(np.sort(rows, -1)[:, :-1], 0.0, atol=2.0 ** -12)


def test_decode_step_counts_equal_curl_tpus_step_body(tiny):
    """curl_tpu's generator of one step (the masks, then its scan body,
    which it counts once) traced, against the port's: equal rounds, bytes
    and calls; the port's second step adds as much as its first."""
    p = TINY
    model = tiny["model"]
    sel, wr, ids = jgenerate.make_masks(p["prompt_len"], 1, p["seq_len"])
    jforward = jgenerate.build_generator(model, 1)
    apply_fn, params = model.functional()

    def japply(prm, buf):
        model.bind_params(prm)
        return jforward(buf, sel, wr, ids)

    curl_tpu.init(world_size=2, seed=0)
    want = _jax_counts(japply, 2, _zero_shares(params), *_jax_enc(2, tiny["buf0"]))
    model.bind_params(params)

    counts = {}
    for steps in (1, 2):
        _, prm, _, run = _port_generator(tiny, steps)
        step = parallel.compile_parties(run, 2)
        step(1, prm, ct.cryptensor(tiny["buf0"]))
        counts[steps] = (step.stats["rounds"], step.stats["bytes"], step.stats["calls"])
    assert counts[1] == want
    model_, prm, _, _ = _port_generator(tiny)
    ct.reset_communication_stats()
    model_.premask_for_reuse()
    premask = ct.get_communication_stats()
    assert premask["rounds"] == 2 + 4 * p["blocks"]  # one delta reveal a weight
    assert counts[2][0] - counts[1][0] == counts[1][0] - premask["rounds"]
    assert counts[2][1] - counts[1][1] == counts[1][1] - premask["bytes"]


def test_compiled_generator_equals_the_eager_step_loop(tiny):
    """The runner on a CPU session runs the generator under the call's keys
    from its first call's draw counter: the eager loop of decode_step under
    the same keys and counter gives the same buffer, share for share; the
    same seed twice is identical; two seeds draw different deltas and
    triples."""
    p = TINY
    model, params, forward, run = _port_generator(tiny)
    buf0 = ct.cryptensor(tiny["buf0"])
    step = parallel.compile_parties(run, 2)
    first, delta1 = step(7, params, buf0)
    again, delta1b = step(7, params, buf0)
    other, delta2 = step(8, params, buf0)

    resume = trng.counter()
    trng.set_counter(step.counter)
    with parallel.mpc_context(trng.make_party_keys(7, 2), 2):
        model.bind_params(params)
        model.premask_for_reuse()
        buf, lasts = buf0, []
        sel, wr = forward.masks
        for g in range(p["gen_tokens"]):
            buf, last = generate.decode_step(model, buf, sel[g], wr[g])
            lasts.append(last.get_plain_text())
    trng.set_counter(resume)
    assert torch.equal(buf.share, first.share)
    assert torch.equal(again.share, first.share) and torch.equal(delta1, delta1b)
    assert not torch.equal(delta1, delta2)
    assert not torch.equal(other.share, first.share)
    assert type(model.fc.weight._tensor) is beaver.MaskedArithmetic
    # each step's choice is the argmax of the logits it revealed
    final = first.get_plain_text()
    for g, last in enumerate(lasts):
        assert int(final[0, p["prompt_len"] + g].argmax()) == int(last[0].argmax())


# -- HuggingFace weights ----------------------------------------------------------

def test_load_hf_state_dict_matches_transformers():
    """tests/test_hf_gpt2.py's tiny GPT-2, built locally: the weights mapped
    (Conv1D transposed, the head tied to wte with a zero bias) and the
    encrypted causal forward against the transformers forward, within
    that test's bounds."""
    os.environ.setdefault("USE_TF", "0")  # a tiny torch model needs no TensorFlow
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(7)
    hf = transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size=64, n_positions=16, n_embd=32, n_layer=2, n_head=2, initializer_range=0.25,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0, activation_function="gelu")).eval()
    ct.init(world_size=2, seed=0, device="cpu")
    ours = load_hf_state_dict(GPT(32, 2, 2, 64, 8, causal=True), hf.state_dict())
    sd = hf.state_dict()
    np.testing.assert_array_equal(ours.tok_embed.weight.numpy(), sd["transformer.wte.weight"])
    np.testing.assert_array_equal(list(ours.blocks)[0].attn.search.weight.numpy(),
                                  sd["transformer.h.0.attn.c_attn.weight"].numpy().T)
    np.testing.assert_array_equal(ours.fc.weight.numpy(), sd["transformer.wte.weight"])
    assert ours.pos_embed.shape == (1, 8, 32) and not ours.fc.bias.any()

    tokens = np.array([[5, 17, 42, 3, 60, 11, 29, 8]])
    with torch.no_grad():
        ref = torch.softmax(hf(torch.tensor(tokens)).logits, -1).numpy()
    probs = ours.encrypt(src=0)(ct.cryptensor(tokens.astype(np.float64), precision=0))
    probs = probs.get_plain_text()
    np.testing.assert_allclose(probs, ref, atol=0.1)
    assert (0.5 * np.abs(probs - ref).sum(-1)).max() < 0.15
    assert (probs.argmax(-1) == ref.argmax(-1)).mean() >= 0.75
