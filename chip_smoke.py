"""Smoke run of mxnet_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--out results.json] [--profile]

Builds the package's CUDA kernels from the sources in this checkout
(``build/kernels/``), then:

1. **Main phase: generation serving at full width.** ``transformer_lm_base``
   (units 768, 12 layers, 12 heads, head_dim 64, vocab 32000, max_len
   2048) with random weights made from ``--seed`` with numpy and loaded
   through ``convert.load_mxnet_params``; ``DecodeEngine`` (8 slots,
   max_seq 2048, ladder 16..1024, float32) behind ``GenerationScheduler``
   behind ``ModelServer`` on an ephemeral port. Eight concurrent
   ``POST /generate`` requests (prompt lengths 5, 37, 100, 128, 200, 511,
   700, 1000; 32 greedy tokens each). Checks that every stream ends with
   ``{"done": true, "reason": "length", "n_tokens": 32}``, that the flash
   kernel launched once per layer per prefill in that run, and that the two
   longest streams equal greedy decoding by re-prefill: one full
   ``forward`` over prompt + stream on the plain attention path, whose
   argmax at each position must be the next streamed token.
2. **Kernel phase.** At the slice's shapes (B 1, H 12, D 64, S 128 and
   1024; causal with a key mask; both layouts; fp32 and bf16; one dropout
   case) each kernel call is held against ``flash_attention_plain`` on the
   card (fp32 atol/rtol 2e-4: sums in another order; bf16 2e-2: P is
   rounded to bf16 before PV) and timed with CUDA events, beside the plain
   version and ``torch.nn.functional.scaled_dot_product_attention`` with
   the same boolean mask (the yardstick only; the package never calls it).

With ``--profile`` the burst is served a second time under
``torch.profiler`` (after the checked run) to print the device's busy share
and its top kernels.

Prints the serving numbers, one ``{"kernels": [...]}`` line, the card's
name and power limit, and last ``{"ok": true, "device": {...}}``. Any
failure exits non-zero before that line. Without CUDA it exits 2.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

PROMPT_LENS = (5, 37, 100, 128, 200, 511, 700, 1000)
NEW_TOKENS = 32
LADDER = (16, 32, 64, 128, 256, 512, 1024)
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # H100 SXM, dense
PEAK_BYTES = 3.35e12
KERNEL_SRC = "mxnet_tpu_torch/csrc/flash_attn_fwd.cu"
REPLACES = "mxnet_tpu/ops/pallas_kernels.py:589"      # _bshd_fwd_kernel
ALSO_REPLACES = "mxnet_tpu/ops/pallas_kernels.py:239"  # _attn_fwd_kernel


def fail(msg):
    raise SystemExit("chip_smoke: FAILED: " + msg)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def random_params(model, seed):
    """Reference-named parameters (``transformerlm0_...``) drawn with
    numpy: N(0, 0.02) weights and biases, LayerNorm gamma 1 and beta 0."""
    from mxnet_tpu_torch import convert
    rng = np.random.default_rng(seed)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    out = {}
    for name, shape in sorted(shapes.items()):
        if name.endswith("gamma"):
            arr = np.ones(shape, np.float32)
        elif name.endswith("beta"):
            arr = np.zeros(shape, np.float32)
        else:
            arr = rng.standard_normal(shape, dtype=np.float32) * 0.02
        out[name] = arr
    import torch
    return convert.mxnet_params_from_state_dict(
        {k: torch.from_numpy(v) for k, v in out.items()})


def stream_generate(url, prompt, results, idx):
    body = json.dumps({"prompt": prompt, "max_new_tokens": NEW_TOKENS,
                       "temperature": 0.0}).encode()
    req = urllib.request.Request(url + "/generate", data=body,
                                 method="POST")
    t0 = time.perf_counter()
    lines = []
    first = None
    with urllib.request.urlopen(req, timeout=600) as r:
        for raw in r:
            if first is None:
                first = time.perf_counter() - t0
            lines.append(json.loads(raw))
    results[idx] = {"lines": lines, "ttft_s": first,
                    "total_s": time.perf_counter() - t0}


def run_burst(url, prompts):
    """All prompts at once, one client thread each; (results, wall s)."""
    results = [None] * len(prompts)
    threads = [threading.Thread(target=stream_generate,
                                args=(url, p, results, i))
               for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results, time.perf_counter() - t0


def profile_burst(torch, url, prompts):
    """The burst once more under ``torch.profiler``: the device's busy time
    (sum of kernel times; one stream) against the burst's wall time, and
    the kernels that took the most device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = run_burst(url, prompts)
        torch.cuda.synchronize()
    per = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            calls, us = per.get(e.name, (0, 0.0))
            per[e.name] = (calls + 1, us + e.time_range.elapsed_us())
    busy_us = sum(us for _, us in per.values())
    top = sorted(per.items(), key=lambda kv: -kv[1][1])[:8]
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / (wall * 1e6),
            "kernels_launched": sum(c for c, _ in per.values()),
            "top_kernels": [{"name": n[:90], "calls": c, "ms": us / 1e3}
                            for n, (c, us) in top]}


def main_phase(args, torch):
    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch.models import transformer_lm_base
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.serving import ModelServer
    from mxnet_tpu_torch.serving.generation import (DecodeEngine,
                                                    GenerationScheduler)
    dev = torch.device("cuda")
    model = transformer_lm_base(vocab_size=32000, max_len=2048, device=dev)
    convert.load_mxnet_params(model, random_params(model, args.seed))
    model.eval()
    eng = DecodeEngine(model, num_slots=8, max_seq=2048, ladder=LADDER,
                       dtype="float32", seed=args.seed, device=dev)
    rng = np.random.default_rng(args.seed + 1)
    prompts = [rng.integers(0, 32000, n).tolist() for n in PROMPT_LENS]
    # warm-up (library handles, kernel load), outside the measured run
    slot = eng.cache.acquire()
    eng.prefill(slot, prompts[0])
    eng.decode_step(np.zeros(eng.num_slots, np.int64),
                    np.zeros(eng.num_slots, np.float32))
    eng.cache.release(slot)
    torch.cuda.synchronize()
    sched = GenerationScheduler(eng)
    srv = ModelServer(None, port=0, generator=sched).start()
    try:
        prefills0 = eng.stats()["prefill_total"]
        fa.reset_launches()
        results, wall = run_burst(srv.url, prompts)
        torch.cuda.synchronize()
        launches = fa.flash_attention_bshd.launches + \
            fa.flash_attention.launches
        prefills = eng.stats()["prefill_total"] - prefills0
        snap = sched.metrics.snapshot()
        prof = profile_burst(torch, srv.url, prompts) if args.profile \
            else None
    finally:
        srv.stop()
    streams = []
    for n, res in zip(PROMPT_LENS, results):
        if res is None:
            fail("request with a %d-token prompt got no reply" % n)
        done = res["lines"][-1]
        want = {"done": True, "reason": "length", "n_tokens": NEW_TOKENS}
        if any(done.get(k) != v for k, v in want.items()):
            fail("prompt %d: stream ended %r" % (n, done))
        toks = [x["token"] for x in res["lines"][:-1]]
        if len(toks) != NEW_TOKENS or not all(0 <= t < 32000 for t in toks):
            fail("prompt %d: bad tokens %r" % (n, toks))
        streams.append(toks)
    if prefills != len(prompts):
        fail("%d prefills for %d requests" % (prefills, len(prompts)))
    if launches != prefills * model.num_layers:
        fail("flash kernel launched %d times for %d prefills x %d layers"
             % (launches, prefills, model.num_layers))
    # greedy by re-prefill: one causal forward over prompt + stream on the
    # plain attention path; position len(prompt)-1+i must predict token i
    checked = []
    before = fa.flash_attention_bshd.launches + fa.flash_attention.launches
    os.environ["MXNET_FLASH_ATTENTION"] = "0"
    try:
        for idx in np.argsort(PROMPT_LENS)[-2:]:
            p, toks = prompts[idx], streams[idx]
            seq = torch.tensor([p + toks[:-1]], device=dev)
            with torch.no_grad():
                logits = model(seq)[0, len(p) - 1:]
            if not bool(torch.isfinite(logits).all()):
                fail("non-finite logits on the plain path")
            ref = logits.argmax(dim=-1).tolist()
            if ref != toks:
                fail("prompt %d: stream %r != re-prefill %r"
                     % (len(p), toks, ref))
            checked.append(len(p))
    finally:
        del os.environ["MXNET_FLASH_ATTENTION"]
    if fa.flash_attention_bshd.launches + fa.flash_attention.launches \
            != before:
        fail("the plain-path check launched the kernel")
    ttfts = sorted(r["ttft_s"] for r in results)
    return {
        "model": "transformer_lm_base", "requests": len(prompts),
        "prompt_lens": list(PROMPT_LENS), "new_tokens": NEW_TOKENS,
        "prefills": prefills, "flash_launches": launches,
        "ttft_ms_p50_client": 1e3 * float(np.median(ttfts)),
        "ttft_ms_server": snap["ttft_ms"],
        "decode_tokens_s": snap["decode_tokens_s"],
        "step_ms_mean": snap["step_ms_mean"],
        "prefill_ms_mean": snap["prefill_ms_mean"],
        "wall_s": wall, "greedy_reprefill_checked": checked,
        "profile": prof,
    }


def time_ms(torch, fn, iters=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def graph_ms(torch, fn, iters=20):
    """Device time per call: ``iters`` calls captured in one CUDA graph
    and replayed, so no Python launch cost sits between them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def bound(B, H, S, D, dtype, causal):
    """Least time for the card: the larger of FLOPs over the dtype's peak
    and bytes (q, k, v, o, key mask, LSE, each moved once) over HBM."""
    flops = 4.0 * B * H * S * S * D * (0.5 if causal else 1.0)
    item = 4 if dtype == "float32" else 2
    nbytes = 4 * B * S * H * D * item + B * S * 4 + B * H * S * 4
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), \
        "operations" if t_ops >= t_bytes else "bytes"


def kernel_phase(torch):
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import flash_attention as fa
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    cases = []
    B, H, D = 1, 12, 64
    specs = [(S, layout, dt, 0.0) for S in (128, 1024)
             for layout in ("BSHD", "BHSD")
             for dt in (torch.float32, torch.bfloat16)]
    specs.append((1024, "BSHD", torch.float32, 0.1))
    for S, layout, dt, drop in specs:
        shape = (B, S, H, D) if layout == "BSHD" else (B, H, S, D)
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(dt)
                   for _ in range(3))
        valid = S - S // 8            # a padded prompt: key 0 always valid
        mask = (torch.arange(S, device=dev) < valid).to(torch.int32)
        mask = mask.reshape(1, S).expand(B, S).contiguous()
        fn = fa.flash_attention_bshd if layout == "BSHD" else \
            fa.flash_attention
        seed = 20240601 if drop else None
        out = fn(q, k, v, mask, seed, True, drop)
        torch.cuda.synchronize()
        ref = fa.flash_attention_plain(q, k, v, mask, seed, True, drop,
                                       layout=layout)
        tol = 2e-4 if dt == torch.float32 else 2e-2
        err = (out.float() - ref.float()).abs().max().item()
        if not torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol):
            fail("kernel != plain: S=%d %s %s dropout=%s max_err=%g"
                 % (S, layout, dt, drop, err))
        ms = time_ms(torch, lambda: fn(q, k, v, mask, seed, True, drop))
        dev_ms = graph_ms(torch, lambda: fn(q, k, v, mask, seed, True, drop))
        plain_ms = time_ms(torch, lambda: fa.flash_attention_plain(
            q, k, v, mask, seed, True, drop, layout=layout), iters=5)
        lib_ms = lib_graph_ms = None
        if drop == 0.0:
            qb, kb, vb = ((x.transpose(1, 2) if layout == "BSHD" else x)
                          for x in (q, k, v))
            keep = torch.ones((S, S), dtype=torch.bool, device=dev).tril() \
                & mask.bool().reshape(B, 1, 1, S)
            lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qb, kb, vb, attn_mask=keep))
            lib_graph_ms = graph_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qb, kb, vb, attn_mask=keep))
        dname = str(dt).replace("torch.", "")
        b_ms, b_by = bound(B, H, S, D, dname, True)
        cases.append({"S": S, "layout": layout, "dtype": dname,
                      "dropout": drop, "causal": True, "key_mask": True,
                      "max_abs_err": err, "tol": tol, "ms": ms,
                      "graph_ms": dev_ms, "plain_ms": plain_ms,
                      "library_ms": lib_ms, "library_graph_ms": lib_graph_ms,
                      "bound_ms": b_ms, "bound_by": b_by})
    return cases


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write every result to this JSON file")
    ap.add_argument("--profile", action="store_true",
                    help="serve the burst a second time under "
                         "torch.profiler and print the device's busy share")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from mxnet_tpu_torch import _build
    t0 = time.perf_counter()
    _build.build(["flash_attn_fwd"])
    build_s = time.perf_counter() - t0
    log = _build.build_log("flash_attn_fwd")
    regs = re.findall(r"Used (\d+) registers", log)
    spills = re.findall(r"(\d+) bytes spill stores", log)
    print("build: flash_attn_fwd in %.1f s; ptxas: %d kernels, registers %s,"
          " spill stores %s" % (build_s, len(regs), ",".join(regs),
                                ",".join(spills)))

    serving = main_phase(args, torch)
    print("serving: %d requests, TTFT p50 %.2f ms (server), %.2f ms "
          "(client); decode %.1f tokens/s; step %.2f ms; prefill %.2f ms"
          % (serving["requests"], serving["ttft_ms_server"]["p50"],
             serving["ttft_ms_p50_client"], serving["decode_tokens_s"],
             serving["step_ms_mean"], serving["prefill_ms_mean"]))
    print("serving: greedy streams equal re-prefill for prompts of %s "
          "tokens; flash launches %d = %d prefills x 12 layers"
          % (serving["greedy_reprefill_checked"], serving["flash_launches"],
             serving["prefills"]))

    prof = serving["profile"]
    if prof is not None:
        print("profile: burst %.1f ms wall, device busy %.1f ms (%.1f%%), "
              "%d kernels; top: %s" % (
                  prof["wall_ms"], prof["device_busy_ms"],
                  100 * prof["device_busy_share"], prof["kernels_launched"],
                  "; ".join("%s x%d %.1f ms" % (k["name"][:40], k["calls"],
                                                 k["ms"])
                            for k in prof["top_kernels"][:5])))

    cases = kernel_phase(torch)
    for c in cases:
        lib = "-" if c["library_ms"] is None else "%.4f ms (graph %.4f)" % (
            c["library_ms"], c["library_graph_ms"])
        print("kernel: S=%-5d %s %-8s dropout=%.1f  %.4f ms (graph %.4f)  "
              "plain %.4f ms  library %s  bound %.4f ms (%s)  max_err %.3g"
              % (c["S"], c["layout"], c["dtype"], c["dropout"], c["ms"],
                 c["graph_ms"], c["plain_ms"], lib, c["bound_ms"],
                 c["bound_by"], c["max_abs_err"]))
    main_case = next(c for c in cases if c["S"] == 1024 and c["layout"]
                     == "BSHD" and c["dtype"] == "float32"
                     and c["dropout"] == 0.0)
    entry = {
        "name": "flash_attn_fwd", "route": "cuda", "source": KERNEL_SRC,
        "replaces": REPLACES, "also_replaces": ALSO_REPLACES,
        "launches": serving["flash_launches"],
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "max_err": max(c["max_abs_err"] for c in cases),
        "kernel_ms": main_case["ms"],
        "timed_case": "B=1 S=1024 H=12 D=64 BSHD float32 causal key-mask",
        "cases": cases,
    }
    card = card_line()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"serving": serving, "kernels": [entry],
                       "card": card, "build_s": build_s}, f, indent=1)
    print(json.dumps({"kernels": [entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
