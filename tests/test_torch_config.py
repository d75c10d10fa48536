"""The config profiles and the session helpers (``curl_tpu_torch/config.py``,
``configs/``, ``curl_tpu_torch/__init__.py``) against curl_tpu's.

* The port's ``llm_config.yaml`` and ``approximations.yaml`` equal the JAX
  package's key for key and value for value (read as YAML files; the fused
  knobs take "cuda" where the JAX package takes "pallas_tpu", and neither
  profile sets one).
* ``init(config_file=)``, ``load_config(None)``, ``cfg[key]``,
  ``set_config`` and ``snapshot``.
* Under each profile, the eight functions of ROADMAP's re-anchor probe at
  64 points in [0.05, 4], each within twice curl_tpu's worst max |error|
  there over 8 session seeds (PR 10's rule), and the tiny GPT of
  tests/test_torch_gpt.py under llm_config with curl_tpu's rounds, bytes
  and calls, its scan_reduction stages counted a step at a time in both
  (curl_tpu counts a ``lax.scan`` body once; ROADMAP Queue C). curl_tpu's
  readings come from ``tests/golden/torch_config_reference.npz``, written by

      JAX_PLATFORMS=cpu python3 tests/torch_config_reference.py

* The config reads the port repaired: each falls back where a partial
  profile lacks its key, as curl_tpu's does.
* ``uninit``, ``is_initialized``, ``init_thread``,
  ``print_communication_stats`` (curl_tpu's text) and the tensor-type
  predicates.
"""

import logging
import math
import os
import sys

import numpy as np
import pytest
import torch
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import curl_tpu_torch as ct  # noqa: E402
from curl_tpu_torch import config as tconfig  # noqa: E402
from curl_tpu_torch.config import cfg  # noqa: E402
from curl_tpu_torch.utils import tensor_types  # noqa: E402

GOLDEN = os.path.join(REPO, "tests", "golden", "torch_config_reference.npz")
PROFILES = ("llm_config", "approximations")
FUNCTIONS = ("gelu", "reciprocal", "inv_sqrt", "log", "sqrt", "erf", "exp", "silu")
POINTS = np.linspace(0.05, 4.0, 64)
SESSION_SEED = 3
# curl_tpu's worst max |error| is taken over these session seeds
WORST_SEEDS = tuple(range(3, 11))
GPT_SEED = 5
# the tiny GPT of tests/test_torch_gpt.py
TINY = dict(embed_dim=8, num_heads=2, num_blocks=1, vocab_size=32, seq_len=4)
BATCH = 8


def _erf(x):
    return np.vectorize(math.erf)(x)


def plain(name, x):
    """float64 values of the probe's functions."""
    return {"gelu": lambda: 0.5 * x * (1 + _erf(x / math.sqrt(2))),
            "reciprocal": lambda: 1 / x, "inv_sqrt": lambda: 1 / np.sqrt(x),
            "log": lambda: np.log(x), "sqrt": lambda: np.sqrt(x), "erf": lambda: _erf(x),
            "exp": lambda: np.exp(x), "silu": lambda: x / (1 + np.exp(-x))}[name]()


def tiny_tokens():
    return np.random.default_rng(3).integers(0, TINY["vocab_size"], (BATCH, TINY["seq_len"]))


def staged_forward(model, embed, x):
    """The final-LayerNorm hidden state and the logits (test_torch_gpt's
    ``_staged_forward`` without the softmax)."""
    h = embed(x)
    for block in model.blocks:
        h = block(h)
    h = model.ln(h)
    return h, model.fc(h)


def _jax_profile(name):
    return os.path.join(REPO, "curl_tpu", "configs", f"{name}.yaml")


@pytest.fixture(autouse=True)
def _default_profile_after():
    yield
    cfg.load_config(None)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


# -- the profiles ---------------------------------------------------------------

def _spelled(value):
    """A knob's value in the port's spelling."""
    return "cuda" if value == "pallas_tpu" else value


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("name", ("default",) + PROFILES)
def test_profile_equals_curl_tpu_yaml(name):
    with open(tconfig.profile(name)) as f:
        port = _flat(yaml.safe_load(f))
    with open(_jax_profile(name)) as f:
        jax_package = {k: _spelled(v) for k, v in _flat(yaml.safe_load(f)).items()}
    assert port == jax_package


def test_profiles_are_partial_where_curl_tpus_are():
    with open(tconfig.profile("default")) as f:
        default = set(_flat(yaml.safe_load(f)))
    for name, missing in (("llm_config", 14), ("approximations", 51)):
        with open(tconfig.profile(name)) as f:
            assert len(default - set(_flat(yaml.safe_load(f)))) == missing, name


# -- the loader -----------------------------------------------------------------

def test_init_with_a_profile_replaces_the_whole_config():
    ct.init(config_file=tconfig.profile("llm_config"), world_size=2, seed=0, device="cpu")
    assert ct.is_initialized()
    assert cfg["functions.gelu_method"] == "bior-lut-only"
    assert "compare_bits" not in cfg.mpc  # replaced, not merged
    cfg.load_config(None)
    with open(tconfig.profile("default")) as f:
        assert cfg.to_dict() == yaml.safe_load(f)


def test_item_access_set_config_and_snapshot():
    snap = cfg.snapshot()
    assert cfg.snapshot() is snap  # rebuilt only after a change
    hash(snap)
    assert cfg["mpc.provider"] == cfg.mpc.provider == "TFP"
    cfg["functions.exp_iterations"] = 4
    assert cfg.functions.exp_iterations == 4 and cfg.snapshot() != snap
    cfg.functions.exp_iterations = 8  # an attribute set on a node moves it too
    assert cfg.snapshot() == snap
    other = tconfig.CurlConfig(tconfig.profile("approximations"))
    cfg.set_config(other)
    assert cfg["functions.gelu_method"] == "erf" and cfg.snapshot() != snap
    cfg.set_config(tconfig.CurlConfig().config)
    assert cfg.snapshot() == snap
    with cfg.temp_override({"mpc.provider": "TTP"}):
        assert cfg.snapshot() != snap
    assert cfg.snapshot() == snap


# -- the profiles' functions against curl_tpu ---------------------------------

@pytest.fixture(scope="module")
def port_functions():
    out = {}
    for profile in PROFILES:
        ct.init(config_file=tconfig.profile(profile), world_size=2, seed=SESSION_SEED,
                device="cpu")
        xe = ct.cryptensor(POINTS)
        for name in FUNCTIONS:
            out[f"{profile}/{name}"] = getattr(xe, name)().get_plain_text()
    cfg.load_config(None)
    return out


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("name", FUNCTIONS)
def test_function_under_profile_within_twice_curl_tpus_error(golden, port_functions, profile,
                                                             name):
    want = plain(name, POINTS)
    got = port_functions[f"{profile}/{name}"]
    assert got.shape == POINTS.shape and np.isfinite(got).all()
    worst = float(golden[f"{profile}/{name}/worst"])
    assert np.abs(golden[f"{profile}/{name}"] - want).max() <= worst
    assert np.abs(got - want).max() <= 2 * worst


def test_tiny_gpt_under_llm_config_counts_as_curl_tpu(golden):
    from curl_tpu_torch.models import GPT, load_numpy_state_dict

    ct.init(config_file=tconfig.profile("llm_config"), world_size=2, seed=GPT_SEED, device="cpu")
    sd = {k[len("gpt/sd/"):]: golden[k] for k in golden.files if k.startswith("gpt/sd/")}
    model = load_numpy_state_dict(GPT(full=True, **TINY), sd)
    model.encrypt(src=0)
    x = ct.cryptensor(golden["gpt/tokens"].astype(np.float64), precision=0)
    ct.reset_communication_stats()
    hidden, logits = staged_forward(model, model.embed, x)
    stats = ct.get_communication_stats()
    assert [stats["rounds"], stats["bytes"]] == golden["gpt/counts"].tolist()
    assert stats["calls"] == dict(zip(golden["gpt/call_names"].tolist(),
                                      golden["gpt/call_counts"].tolist()))
    for got, key in ((hidden, "hidden"), (logits, "logits")):
        got = got.get_plain_text()
        assert got.shape == golden[f"gpt/{key}"].shape and np.isfinite(got).all()


# -- the reads repaired ----------------------------------------------------------

def _counts(fn):
    ct.reset_communication_stats()
    fn()
    s = ct.get_communication_stats()
    return s["rounds"], s["bytes"]


def test_lookup_tables_build_under_a_profile_without_their_sizes():
    """approximations.yaml has no table sizes: the tables store builds (it
    read every table's sizes at once, and raised), with nothing to build."""
    from curl_tpu_torch.functions.luts import LookupTables

    ct.init(config_file=tconfig.profile("approximations"), world_size=2, seed=0, device="cpu")
    assert LookupTables().LUTs.names() == []


def test_softmax_refinement_falls_back_to_two_steps():
    """functions.softmax_recip_refine absent: 2 Newton steps
    (curl_tpu/functions/approximations.py:740-743)."""
    ct.init(config_file=tconfig.profile("llm_config"), world_size=2, seed=0, device="cpu")
    xe = ct.cryptensor(np.linspace(-2, 2, 16).reshape(2, 8))
    absent = _counts(lambda: xe.softmax(-1))
    with cfg.temp_override({"functions.softmax_recip_refine": 2}):
        assert _counts(lambda: xe.softmax(-1)) == absent
    with cfg.temp_override({"functions.softmax_recip_refine": 1}):
        assert _counts(lambda: xe.softmax(-1)) != absent


def test_scan_reduction_widths_fall_back_to_curl_tpus():
    """functions.scan_fixed_width, scan_cascade_factor and scan_cascade_min
    absent: 2048, 8 and 128 (curl_tpu/functions/maximum.py:299-316)."""
    ct.init(config_file=tconfig.profile("approximations"), world_size=2, seed=0, device="cpu")
    x = np.random.default_rng(0).normal(size=(2, 300))
    xe = ct.cryptensor(x)
    with cfg.temp_override({"functions.max_method": "scan_reduction"}):
        absent = _counts(lambda: xe.max(-1))
        got = xe.max(-1)[0].get_plain_text()
        with cfg.temp_override({"functions.scan_fixed_width": 2048,
                                "functions.scan_cascade_factor": 8,
                                "functions.scan_cascade_min": 128}):
            assert _counts(lambda: xe.max(-1)) == absent
    np.testing.assert_allclose(got, x.max(-1), atol=2e-4)


# -- the session helpers ---------------------------------------------------------

def test_uninit_and_init_thread():
    ct.init(world_size=2, seed=0, device="cpu")
    assert ct.is_initialized()
    ct.uninit()
    assert not ct.is_initialized()
    with pytest.raises(RuntimeError):
        ct.cryptensor([1.0])
    ct.init_thread(rank=0, world_size=3, seed=1, device="cpu")
    assert ct.is_initialized() and ct.comm.get_world_size() == 3
    np.testing.assert_allclose(ct.cryptensor([1.5]).get_plain_text(), [1.5])


def test_print_communication_stats_text_as_curl_tpu(caplog):
    from curl_tpu import comm as jcomm

    text = {}
    for name, comm in (("port", ct.comm), ("curl_tpu", jcomm)):
        comm.reset_communication_stats()
        comm.comm_stats.rounds, comm.comm_stats.bytes = 7, 4096
        comm.comm_stats.calls.update({"all_sum": 5, "all_xor": 2})
        caplog.clear()
        with caplog.at_level(logging.INFO):
            (ct.print_communication_stats if name == "port" else comm.print_communication_stats)()
        text[name] = [r.getMessage() for r in caplog.records]
        comm.reset_communication_stats()
    assert text["port"] == text["curl_tpu"]
    assert text["port"][:3] == ["====Communication Stats====", "Rounds: 7", "Bytes: 4096"]


def test_log_print_and_print_in_order(caplog, capsys):
    with caplog.at_level(logging.INFO):
        ct.log("logged %d", 3)
    assert "logged 3" in caplog.text
    ct.print("a", 1, dst=1)
    ct.print_in_order("b")
    assert capsys.readouterr().out == "a 1\nb\n"


@pytest.mark.parametrize("value, tensor, floating, integer", [
    (np.zeros(3), True, True, False),
    (np.zeros(3, dtype=np.int32), True, False, True),
    (torch.zeros(3), True, True, False),
    (torch.zeros(3, dtype=torch.int64), True, False, True),
    (torch.zeros(3, dtype=torch.bool), True, False, False),
    ([1.0, 2.0], False, False, False),
    (1.5, False, False, False),
])
def test_tensor_type_predicates(value, tensor, floating, integer):
    assert tensor_types.is_tensor(value) is tensor
    assert tensor_types.is_float_tensor(value) is floating
    assert tensor_types.is_int_tensor(value) is integer
    assert not tensor_types.is_encrypted_tensor(value)


def test_is_encrypted_tensor():
    ct.init(world_size=2, seed=0, device="cpu")
    assert tensor_types.is_encrypted_tensor(ct.cryptensor([1.0]))
