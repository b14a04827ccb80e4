"""The ROADMAP C10 probes on one NVIDIA GPU: is the bf16 flash kernel at
fault when the predict phase's bf16 check fails, and how noisy is each
statistic that the check reads?

    python3 chip_c10.py --part layers   # the failing inputs, layer by layer
    python3 chip_c10.py --part sample   # the check's statistics over draws

Both build the bf16 BERT-base of ``chip_smoke.py``'s predict phase
(``chip_smoke.predict_net``, seed 0, cast to bf16) and an fp32 copy of its
bf16 weights as the truth, and serve through ``chip_smoke``'s helpers.
``layers``: on C10's inputs (``chip_smoke._c10_inputs``), each path's
distance from the fp32 path for each served output (the pooled [CLS] row
and the NSP logits); for every layer's attention the kernel's and the
plain path's distance from the float64 attention of the layer's inputs,
and the kernel's from an emulation of its design (fp32 softmax, P rounded
to bf16 for PV, an fp32 normaliser); then the kernel/plain ratio of each
output over 200 random bucket-2 draws. ``sample``: 100 simulated bf16
passes, every bucket once: each bucket's ratio for each output, and each
output's ratio over a pass's rows. Each prints its results as one JSON
line, then the card's name and power limit.
"""
import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

OUTPUTS = ("pooled", "nsp")


def _paths(torch, cs, net, net32, t, s, v):
    """The served outputs: the kernel path, the plain path, and the plain
    path of the fp32 copy."""
    def plain(n):
        return cs.on_plain_path(
            lambda: cs._served_eager(torch, n, t, s, v), "chip_c10")
    return cs._served_eager(torch, net, t, s, v), plain(net), plain(net32)


def _distances(cs, ker, pl, tr):
    """``{output: (kernel, plain)}``, each path's distance from fp32."""
    return {name: (cs.rel_to_max(k, r), cs.rel_to_max(p, r))
            for name, k, p, r in zip(OUTPUTS, ker, pl, tr)}


def _emulated(torch, q, k, v, mask):
    """The bf16 kernel's design in plain PyTorch: fp32 scores and softmax,
    P rounded to bf16 for PV, the fp32 row sums as normaliser."""
    q, k, v = (x.float().transpose(1, 2) for x in (q, k, v))
    sc = q @ k.transpose(-1, -2) / q.shape[-1] ** 0.5
    if mask is not None:
        sc = sc.masked_fill(~mask.bool()[:, None, None, :], float("-inf"))
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    o = (p.bfloat16().float() @ v) / p.sum(-1, keepdim=True)
    return o.bfloat16().transpose(1, 2)


def _over(ratios, limit):
    return int(sum(r > limit for r in ratios))


def part_layers(torch, cs, net, net32, dev):
    t, s, v = cs._c10_inputs(torch, dev)
    case = {"valid_len": v.tolist()}
    case["outputs"] = _distances(cs, *_paths(torch, cs, net, net32,
                                             t, s, v))
    _, calls = cs._attention_inputs(
        torch, lambda: cs._served_eager(torch, net, t, s, v))
    layers = []
    for (kd, pd), (q, k, vv, m, o) in zip(
            cs._attention_distances(torch, calls), calls):
        em = _emulated(torch, q, k, vv, m)
        layers.append({"kernel": kd, "plain": pd,
                       "emulation": cs.rel_to_max(
                           em, cs._attention64(torch, q, k, vv, m)),
                       "kernel_vs_emulation": cs.rel_to_max(o, em)})
    rng = np.random.default_rng(1234)
    draws = []
    for _ in range(200):
        t, s, v = cs._bucket_inputs(torch, rng, 2, dev)
        draws.append(_distances(cs, *_paths(torch, cs, net, net32,
                                            t, s, v)))
    sample = {}
    for name in OUTPUTS:
        r = sorted(d[name][0] / d[name][1] for d in draws)
        sample[name] = {"median_ratio": r[len(r) // 2], "max_ratio": r[-1],
                        "over2": _over(r, 2.0),
                        "mean_kernel": float(np.mean([d[name][0]
                                                      for d in draws])),
                        "mean_plain": float(np.mean([d[name][1]
                                                     for d in draws]))}
    sample["either_over2"] = _over(
        [max(d[n][0] for n in OUTPUTS) / max(d[n][1] for n in OUTPUTS)
         for d in draws], 2.0)
    case["layers"] = layers
    return {"c10_case": case, "bucket2_draws": sample}


def part_sample(torch, cs, net, net32, dev):
    from mxnet_tpu_torch.serving import DEFAULT_BUCKETS
    rng = np.random.default_rng(99)
    per_bucket = {name: [] for name in OUTPUTS + ("either",)}
    per_pass = {name: [] for name in OUTPUTS}
    for _ in range(100):
        rows = []
        for b in DEFAULT_BUCKETS:
            t, s, v = cs._bucket_inputs(torch, rng, b, dev)
            paths = _paths(torch, cs, net, net32, t, s, v)
            rows.append(paths)
            d = _distances(cs, *paths)
            for name in OUTPUTS:
                per_bucket[name].append(d[name][0] / d[name][1])
            per_bucket["either"].append(max(d[n][0] for n in OUTPUTS)
                                        / max(d[n][1] for n in OUTPUTS))
        for j, name in enumerate(OUTPUTS):
            k, p, r = (torch.cat([x[i][j] for x in rows]) for i in range(3))
            per_pass[name].append(cs.rel_to_max(k, r) / cs.rel_to_max(p, r))
    res = {"buckets": len(per_bucket["pooled"]), "passes": 100}
    for name, rs in per_bucket.items():
        res["per_bucket_" + name] = {"max": max(rs), "median": float(
            np.median(rs)), "over2": _over(rs, 2.0)}
    for name, rs in per_pass.items():
        res["per_pass_" + name] = {"max": max(rs), "median": float(
            np.median(rs)), "over2": _over(rs, 2.0)}
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--part", choices=("layers", "sample"), required=True)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_c10: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    from mxnet_tpu_torch import _build, autograd
    from mxnet_tpu_torch.models import bert_base
    _build.build(cs.SOURCES)
    dev = torch.device("cuda")
    net = cs.predict_net(torch, cs.C10_SEED)
    net.cast("bfloat16")
    net32 = bert_base(vocab_size=cs.BERT_VOCAB, max_length=cs.BERT_SEQ,
                      device=dev)
    net32.load_state_dict(net.state_dict())
    net32.eval()
    with autograd.predict_mode(), torch.no_grad():
        res = {"layers": part_layers, "sample": part_sample}[args.part](
            torch, cs, net, net32, dev)
    print(json.dumps(res))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
