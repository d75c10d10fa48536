#!/usr/bin/env python3
"""Smoke run of curl_tpu_torch on one CUDA card: kernels, then the private
2-party GPT-2 forward.

    python3 chip_smoke.py

Phases, one line each (any failure raises and the run exits non-zero
without the final line):

  1. device   the card's name and power limit (nvidia-smi); raises without CUDA
  2. build    both kernels from curl_tpu_torch/csrc with nvcc for sm_90a
  3. kernels  ring_mm and philox against their plain torch versions at the
              main path's shapes and layouts, bit for bit; philox's time
              and bound
  4. forward  GPT-2 (768 wide, 12 heads, 12 blocks, vocab 50257) under
              configs/default.yaml, random weights from a numpy seed,
              encrypted by party 0; a private forward on 64 token ids
              (batch 1): latency, rounds and bytes, kernel launches of one
              forward, peak memory, and the final-LayerNorm hidden state
              against a float64 plaintext forward of the same weights,
              beside a planted fault (one block left out) that must fail
              the same bound
  5. path     every operand layout the forward passed to ring_mm, on fresh
              operands of the same shapes and strides: bit for bit against
              plain, timed, and summed over the forward's launches

It prints one JSON line with every kernel's numbers, then the card's
name and power limit, then ``{"ok": true, "device": {...}}`` as the last line.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

SEQ = 64
SEED = 11
# Bounds on the decoded final-LayerNorm hidden state against the float64
# plaintext forward (PERF.md, "Hidden-state error bound"; the readings come
# from `python tests/test_torch_gpt.py --bound --blocks 12` on the CPU and
# from this script's own lines). The max |error| is set by single elements
# in the private inv_sqrt's widest table cells, which err by one factor per
# row: twice the largest error curl_tpu shows at GPT-2 width. It catches
# gross faults only. The relative L2 error left after one scale per row
# (hidden_stats' ``scale_free_l2``) separates a sound forward from a wrong
# one: curl_tpu reads 0.124 at 12 blocks, the plaintext forward without
# one block lies 0.18 or more from the full one, and the script also runs a
# private forward with one block left out (the block whose absence the
# plaintext forward feels least) and requires its error to exceed the bound.
HIDDEN_STATE_ATOL = 2.3
HIDDEN_STATE_SCALE_FREE_L2 = 0.15

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps):
    """Mean device milliseconds of ``fn`` over ``reps`` runs (CUDA events),
    after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def rand_i64(gen, shape, dev):
    return torch.randint(-(2 ** 63), 2 ** 63 - 1, shape, generator=gen, dtype=torch.int64,
                         device="cpu").to(dev)


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _operand(gen, spec, dev):
    """A random int64 operand: a plain shape, ("t", n, k) for the (k, n)
    transpose of a contiguous (n, k) tensor, or ("kperm", *shape) for
    attention's key layout, a (b, t, h, d) tensor permuted to (b, h, d, t)
    (with the party axis in front)."""
    if spec[0] == "t":
        return rand_i64(gen, spec[1:], dev).t()
    if spec[0] == "kperm":
        return rand_i64(gen, spec[1:], dev).permute(0, 1, 3, 4, 2)
    return rand_i64(gen, spec, dev)


def _strided_i64(gen, shape, stride, dev):
    """A random int64 tensor with the given shape and strides (broadcast
    dims keep stride 0), over a buffer just large enough for them."""
    span = 1 + sum((n - 1) * st for n, st in zip(shape, stride))
    return rand_i64(gen, (span,), dev).as_strided(shape, stride)


def check_ring_mm(dev, gen):
    from curl_tpu_torch.kernels import ring_mm

    cases = {
        "qkv (2,64,768)@(768,2304) shared B": [((2, 64, 768), (768, 2304))],
        "scores (2,12,64,64)@(2,12,64,64)": [((2, 12, 64, 64), (2, 12, 64, 64))],
        "lm_head (64,768)@(768,50257)": [((64, 768), (768, 50257))],
        "acc2 qkv eps@b + x@delta": [((1, 64, 768), (2, 1, 768, 2304)),
                                     ((2, 1, 64, 768), (768, 2304))],
        "ragged (3,5,37,129)@(129,65)": [((3, 5, 37, 129), (129, 65))],
        # the layouts the path passes: Linear's weight.t(), attention's
        # key.permute(0, 2, 3, 1), the embedding's K = 50257 one-hot product
        "acc2 x@weight.t() (B column-major)": [((1, 64, 768), (2, 1, 768, 2304)),
                                               ((2, 1, 64, 768), ("t", 2304, 768))],
        "scores q@key.permute(0,2,3,1)": [((2, 1, 12, 64, 64), ("kperm", 2, 1, 64, 12, 64))],
        "embedding (2,64,50257)@(50257,768)": [((2, 64, 50257), (50257, 768))],
    }
    for name, shapes in cases.items():
        pairs = [(_operand(gen, sa, dev), _operand(gen, sb, dev)) for sa, sb in shapes]
        got = ring_mm.ring_mm(pairs)
        want = ring_mm.plain(pairs)
        if not torch.equal(got, want):
            raise AssertionError(f"ring_mm {name}: kernel != plain")
        if name.startswith("qkv"):
            a, b = pairs[0]
            if not torch.equal(got.cpu(), torch.matmul(a.cpu(), b.cpu())):
                raise AssertionError("ring_mm qkv: kernel != CPU int64 matmul")
        log(f"[kernels] ring_mm {name}: bit-exact vs plain")


def check_philox(dev, gen):
    from curl_tpu_torch.kernels import philox

    ring_keys = [0x0123456789ABCDEF, 0x0FEDCBA987654321]
    entry = None
    for n in (768 * 50257, 1_000_003):
        plain_n = rand_i64(gen, (n,), dev)
        plain_lane = rand_i64(gen, (2, n), dev)
        args = {
            "draw": dict(keys=[ring_keys[0]], kbits=64),
            "draw_k20": dict(keys=[ring_keys[1]], kbits=20),
            "przs": dict(keys=ring_keys),
            "share": dict(keys=ring_keys, plain=plain_n, src=0),
            "share_lane": dict(keys=ring_keys, plain=plain_lane, src=1),
        }
        for label, kw in args.items():
            mode = label.split("_k")[0]
            got = philox.philox(mode, counter=77, n=n, device=dev, **kw)
            want = philox.plain_philox(mode, counter=77, n=n, device=dev, **kw)
            if not torch.equal(got, want):
                raise AssertionError(f"philox {label} n={n}: kernel != plain")
            if mode == "przs" and torch.count_nonzero(got.sum(0)) != 0:
                raise AssertionError("philox przs rows do not sum to zero")
        log(f"[kernels] philox draw/przs/share/share_lane n={n}: bit-exact vs plain, "
            "PRZS sums to zero")
        if entry is None:
            kw = dict(keys=ring_keys, plain=plain_n, src=0)
            ms = cuda_ms(lambda: philox.philox("share", counter=5, n=n, **kw), 10)
            plain_ms = cuda_ms(lambda: philox.plain_philox("share", counter=5, n=n, **kw), 2)
            nbytes = (2 * n + n) * 8  # (P, n) written once, plain read once
            entry = dict(
                name="philox", route="cuda", source="curl_tpu_torch/csrc/philox.cu",
                replaces="curl_tpu/ops/pallas_przs.py:218", shape=f"share (2, {n})",
                max_abs_err=0, ms=ms, plain_ms=plain_ms,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes", library_ms=None,
            )
            log(f"[kernels] philox share (2, {n}): {ms:.3f} ms (plain {plain_ms:.3f} ms, "
                f"bound {entry['bound_ms']:.4f} ms by bytes)")
    return [entry]


# ---------------------------------------------------------------------------
# Phase 4: the private GPT-2 forward
# ---------------------------------------------------------------------------

def random_gpt2_state(rng, seq, blocks, d=768, vocab=50257):
    """Weights in the JAX package's init distributions (nn/module.py:571-598):
    Embedding normal, Linear weight and bias uniform in +-1/sqrt(fan_in),
    LayerNorm 1 and 0, pos_embed 0."""
    def lin(prefix, fan_in, fan_out):
        b = 1.0 / math.sqrt(fan_in)
        sd[f"{prefix}.weight"] = rng.uniform(-b, b, size=(fan_out, fan_in))
        sd[f"{prefix}.bias"] = rng.uniform(-b, b, size=(fan_out,))

    def ln(prefix):
        sd[f"{prefix}.weight"] = np.ones(d)
        sd[f"{prefix}.bias"] = np.zeros(d)

    sd = {"pos_embed": np.zeros((1, seq, d)), "tok_embed.weight": rng.standard_normal((vocab, d))}
    for i in range(blocks):
        p = f"blocks.{i}"
        ln(f"{p}.ln1")
        ln(f"{p}.ln2")
        lin(f"{p}.attn.search", d, 3 * d)
        lin(f"{p}.attn.proj", d, d)
        lin(f"{p}.ff.0", d, 4 * d)
        lin(f"{p}.ff.2", 4 * d, d)
    ln("ln")
    lin("fc", d, vocab)
    return sd


def plain_gpt_forward(sd, tokens, heads, blocks, dev, skip=None, head=True):
    """float64 plaintext forward: (final-LayerNorm hidden state, probs),
    probs None without ``head``; block ``skip`` is left out."""
    W = {k: torch.as_tensor(v, dtype=torch.float64, device=dev) for k, v in sd.items()}
    ids = torch.as_tensor(tokens, dtype=torch.int64, device=dev)

    def ln(x, p):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + 1e-5) * W[f"{p}.weight"] + W[f"{p}.bias"]

    def lin(x, p):
        return x @ W[f"{p}.weight"].T + W[f"{p}.bias"]

    x = W["tok_embed.weight"][ids] + W["pos_embed"][:, : ids.shape[1]]
    b, t, d = x.shape
    hd = d // heads
    for i in range(blocks):
        if i == skip:
            continue
        p = f"blocks.{i}"
        q, k, v = lin(ln(x, f"{p}.ln1"), f"{p}.attn.search").split(d, dim=-1)
        q, k, v = (z.reshape(b, t, heads, hd).transpose(1, 2) for z in (q, k, v))
        att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1)
        y = (att @ v).transpose(1, 2).reshape(b, t, d)
        x = x + lin(y, f"{p}.attn.proj")
        h = lin(ln(x, f"{p}.ln2"), f"{p}.ff.0")
        h = 0.5 * h * (1 + torch.erf(h / math.sqrt(2)))
        x = x + lin(h, f"{p}.ff.2")
    hidden = ln(x, "ln")
    return hidden, torch.softmax(lin(hidden, "fc"), dim=-1) if head else None


def hidden_stats(got, ref):
    """Errors of a decoded hidden state against the plaintext: max |error|,
    mean |error|, the relative L2 error ||got - ref|| / ||ref||, and the
    relative L2 error left after fitting one scale per row
    (``scale_free_l2``). A LayerNorm's private inv_sqrt errs by one factor
    per row (the table's cells are 1.0 wide), which the last statistic
    does not count; a wrong forward changes the rows' directions."""
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    err = got - ref
    g = got.reshape(-1, got.shape[-1])
    r = ref.reshape(-1, ref.shape[-1])
    scale = (g * r).sum(-1, keepdims=True) / (r * r).sum(-1, keepdims=True)
    return {"max_abs": float(np.abs(err).max()), "mean_abs": float(np.abs(err).mean()),
            "rel_l2": float(np.linalg.norm(err) / np.linalg.norm(ref)),
            "scale_free_l2": float(np.linalg.norm(g - scale * r) / np.linalg.norm(scale * r))}


def fmt_stats(st):
    return (f"max |err| {st['max_abs']:.5f}, mean |err| {st['mean_abs']:.5f}, "
            f"rel L2 {st['rel_l2']:.5f}, scale-free rel L2 {st['scale_free_l2']:.5f}")


@contextlib.contextmanager
def recording_ring_mm(calls):
    """Count, by operand shapes and strides, every ring_mm launch made
    while the context is open (the wrapper's own launch count is kept)."""
    from curl_tpu_torch.kernels import ring_mm

    orig = ring_mm.ring_mm

    def recording(pairs):
        pairs = list(pairs)
        sig = tuple((tuple(a.shape), a.stride(), tuple(b.shape), b.stride()) for a, b in pairs)
        calls[sig] = calls.get(sig, 0) + 1
        return orig(pairs)

    ring_mm.ring_mm = recording
    try:
        yield calls
    finally:
        ring_mm.ring_mm = orig


def private_hidden(model, xe, skip=None):
    """The final-LayerNorm hidden state of a private forward through the
    model's own modules in forward order, block ``skip`` left out."""
    h = model.embed(xe)
    for i, block in enumerate(model.blocks):
        if i != skip:
            h = block(h)
    return model.ln(h)


def profile_forward(model, xe, best_s):
    """One more forward under torch.profiler: the device's busy time (sum
    of kernel self time) against the best unprofiled latency, and the
    kernels that take the most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model(xe)
        torch.cuda.synchronize()
    # device-side events only: a host op's device time repeats its kernels'
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    if busy_ms == 0:
        log("[profile] the profiler recorded no device time: device busy share not measured")
        return
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    log(f"[profile] device busy {busy_ms:.1f} ms per forward, "
        f"{busy_ms / (best_s * 1e3):.1%} of the best unprofiled latency {best_s * 1e3:.1f} ms")
    for e in top:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.2f} ms  {e.count:6d}x  {e.key[:90]}")


def run_forward(dev):
    import curl_tpu_torch as ct
    from curl_tpu_torch.kernels import philox, ring_mm
    from curl_tpu_torch.models import GPT2, load_numpy_state_dict

    blocks, heads = 12, 12
    ct.init(world_size=2, seed=SEED)
    t0 = time.perf_counter()
    sd = random_gpt2_state(np.random.default_rng(1234), SEQ, blocks)
    model = load_numpy_state_dict(GPT2(seq_len=SEQ), sd)
    torch.cuda.reset_peak_memory_stats()
    model.encrypt(src=0)
    torch.cuda.synchronize()
    log(f"[forward] GPT-2 built and encrypted in {time.perf_counter() - t0:.1f} s")

    # token ids drawn as bench.py draws them
    tokens = np.random.default_rng(0).integers(0, 1000, size=(1, SEQ)).astype(np.float64)
    xe = ct.cryptensor(tokens, precision=0)

    # warm-up forward through the model's own modules in forward order,
    # keeping the final-LayerNorm hidden state and recording the operand
    # layouts of every ring_mm launch
    calls = {}
    t0 = time.perf_counter()
    with recording_ring_mm(calls):
        h = private_hidden(model, xe)
        probs = model.softmax(model.fc(h))
    hidden = h.get_plain_text()
    probs = probs.get_plain_text()
    log(f"[forward] warm-up forward {time.perf_counter() - t0:.2f} s")

    ids = tokens.astype(np.int64)
    ref_hidden, ref_probs = plain_gpt_forward(sd, ids, heads, blocks, dev)
    ref_hidden = ref_hidden.cpu().numpy()
    sound = hidden_stats(hidden, ref_hidden)
    probs_err = float(np.abs(probs - ref_probs.cpu().numpy()).max())

    lat = []
    for i in range(3):
        if i == 2:
            ring_mm.reset_launches()
            philox.reset_launches()
            ct.reset_communication_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model(xe)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        if i == 2:
            rm_launches = dict(ring_mm.launches)
            ph_launches = dict(philox.launches)
            stats = ct.get_communication_stats()
    out = out.get_plain_text()

    log(f"[forward] latencies {', '.join(f'{x:.4f}' for x in lat)} s; "
        f"{SEQ / min(lat):.1f} tokens/s (best)")
    log(f"[forward] one forward: {stats['rounds']} rounds, {stats['bytes']} bytes per party")
    log(f"[forward] one forward: ring_mm launches {rm_launches}, philox launches {ph_launches}")
    log(f"[forward] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"[forward] final-LN hidden: {fmt_stats(sound)} (bounds: max {HIDDEN_STATE_ATOL}, "
        f"scale-free rel L2 {HIDDEN_STATE_SCALE_FREE_L2}); probabilities max |err| "
        f"{probs_err:.5f} (reported, not asserted)")
    profile_forward(model, xe, min(lat))

    # a planted fault: the private forward without the block whose absence
    # the plaintext forward feels least must fail the scale-free bound
    skip_err = [hidden_stats(plain_gpt_forward(sd, ids, heads, blocks, dev, skip=j,
                                               head=False)[0].cpu().numpy(),
                             ref_hidden)["scale_free_l2"] for j in range(blocks)]
    j = int(np.argmin(skip_err))
    fault = hidden_stats(private_hidden(model, xe, skip=j).get_plain_text(), ref_hidden)
    log(f"[forward] plaintext with one block left out, scale-free rel L2: min "
        f"{skip_err[j]:.5f} (block {j}), max {max(skip_err):.5f}")
    log(f"[forward] planted fault, private forward without block {j}: {fmt_stats(fault)}")

    # the forward's checks; main() raises on any of them once phase 5 has
    # reported too
    failures = []
    if out.shape != (1, SEQ, 50257) or not np.isfinite(out).all():
        failures.append(f"forward output {out.shape} is not finite (1, {SEQ}, 50257)")
    if not np.isfinite(hidden).all():
        failures.append("final-LN hidden state is not finite")
    bound = HIDDEN_STATE_SCALE_FREE_L2
    if sound["max_abs"] > HIDDEN_STATE_ATOL or sound["scale_free_l2"] > bound:
        failures.append(f"final-LN hidden error ({fmt_stats(sound)}) exceeds its bounds")
    if fault["scale_free_l2"] <= bound:
        failures.append(f"the planted fault ({fmt_stats(fault)}) passes the bound {bound}: "
                        "the check cannot tell it from a sound run")
    if rm_launches.get(1, 0) < 74 or rm_launches.get(2, 0) < 74:
        failures.append(f"ring_mm launched fewer than 74 times per form: {rm_launches}")
    if sum(ph_launches.values()) == 0:
        failures.append("philox was not launched on the main path")
    recorded = {}
    for sig, n in calls.items():
        recorded[len(sig)] = recorded.get(len(sig), 0) + n
    if recorded != rm_launches:
        failures.append(f"recorded ring_mm launches {recorded} != counted {rm_launches}")
    launches = {"ring_mm": rm_launches.get(1, 0), "ring_mm_acc": rm_launches.get(2, 0),
                "philox": sum(ph_launches.values())}
    return launches, calls, failures


# ---------------------------------------------------------------------------
# Phase 5: ring_mm in the layouts the forward passed
# ---------------------------------------------------------------------------

def _distinct_numel(shape, stride):
    """Elements a tensor view reads once: broadcast (stride-0) dims count once."""
    return math.prod(n for n, st in zip(shape, stride) if st != 0)


def check_path_ring_mm(calls, dev, gen):
    """Every (shapes, strides) signature the forward passed to ring_mm, on
    fresh random operands of the same layout: bit-exact against plain, then
    timed; the forward's ring_mm time is each signature's time times its
    launches, split by form, shape and layout."""
    from curl_tpu_torch.kernels import ring_mm

    rows = []
    for sig, count in calls.items():
        pairs = [(_strided_i64(gen, sa, st_a, dev), _strided_i64(gen, sb, st_b, dev))
                 for sa, st_a, sb, st_b in sig]
        got = ring_mm.ring_mm(pairs)
        if not torch.equal(got, ring_mm.plain(pairs)):
            raise AssertionError(f"ring_mm at the path layout {sig}: kernel != plain")
        ms = cuda_ms(lambda: ring_mm.ring_mm(pairs), 3)
        # the same product on contiguous operands: what the layout costs
        dense = [(a.contiguous(), b.contiguous()) for a, b in pairs]
        dense_ms = cuda_ms(lambda: ring_mm.ring_mm(dense), 3)
        plain_ms = cuda_ms(lambda: ring_mm.plain(pairs), 1)
        nbytes = sum(_distinct_numel(sa, st_a) + _distinct_numel(sb, st_b)
                     for sa, st_a, sb, st_b in sig) * 8 + got.numel() * 8
        macs = sum(got.numel() * sa[-1] for sa, _, _, _ in sig)
        rows.append(dict(sig=sig, count=count, ms=ms, dense_ms=dense_ms, plain_ms=plain_ms,
                         t_bytes=nbytes / HBM_BYTES_PER_S * 1e3,
                         t_ops=36 * 2 * macs / INT8_OPS_PER_S * 1e3))
        del pairs, dense, got
        torch.cuda.empty_cache()

    entries = []
    for name, n_pairs, replaces in (("ring_mm", 1, "curl_tpu/ops/pallas_ring_mm.py:149"),
                                    ("ring_mm_acc", 2, "curl_tpu/ops/pallas_ring_mm.py:324")):
        form = sorted((r for r in rows if len(r["sig"]) == n_pairs),
                      key=lambda r: -r["ms"] * r["count"])
        tot = {k: sum(r[k] * r["count"] for r in form)
               for k in ("ms", "dense_ms", "plain_ms", "t_bytes", "t_ops")}
        for r in form:
            layout = " + ".join(f"{sa}{st_a}@{sb}{st_b}" for sa, st_a, sb, st_b in r["sig"])
            log(f"[path] {name} x{r['count']}: {r['ms']:.3f} ms each, "
                f"{r['ms'] * r['count']:.2f} ms a forward "
                f"({r['ms'] * r['count'] / tot['ms']:.1%}); contiguous {r['dense_ms']:.3f} ms; "
                f"bound {max(r['t_bytes'], r['t_ops']):.4f} ms; plain {r['plain_ms']:.2f} ms; "
                f"shapes(strides) {layout}")
        bound, by = ((tot["t_bytes"], "bytes") if tot["t_bytes"] >= tot["t_ops"]
                     else (tot["t_ops"], "operations"))
        log(f"[path] {name}: one forward's {sum(r['count'] for r in form)} launches over "
            f"{len(form)} layouts, bit-exact vs plain: {tot['ms']:.2f} ms "
            f"(on contiguous operands {tot['dense_ms']:.2f} ms; bound {bound:.3f} ms by {by}; "
            f"plain {tot['plain_ms']:.1f} ms)")
        entries.append(dict(
            name=name, route="cuda", source="curl_tpu_torch/csrc/ring_mm.cu", replaces=replaces,
            shape=f"one forward: every launch, {len(form)} layouts",
            max_abs_err=0, ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=bound, bound_by=by,
            library_ms=None,
        ))
    return entries


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this runs on a CUDA card")
    import curl_tpu_torch  # noqa: F401  (fails where the package is missing)
    from curl_tpu_torch.kernels import build

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    log(f"[device] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    secs = build.build_all()
    log(f"[build] ring_mm and philox built for sm_90a in {secs:.1f} s")
    for name, text in sorted(build.build_logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    gen = torch.Generator().manual_seed(5)
    check_ring_mm(dev, gen)
    kernels = check_philox(dev, gen)
    torch.cuda.empty_cache()

    launches, calls, failures = run_forward(dev)
    kernels = check_path_ring_mm(calls, dev, gen) + kernels
    if failures:
        raise AssertionError("; ".join(failures))
    for k in kernels:
        k["launches"] = launches[k["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "shape")
    print(json.dumps({"kernels": [{key: k[key] for key in keys} for k in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
