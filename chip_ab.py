"""Two checkouts' step times, in one call on one card.

    python3 chip_ab.py [--phases train|quant_sparse] TREE [TREE ...]

For each checkout in turn (give each twice, in the order parent, change,
change, parent), a new process imports that checkout's ``chip_smoke.py``
and runs its phases with every check they make. ``train`` (the default)
builds the kernels and runs the training phase (``transformer_lm_base``,
b32 s512, 8 fp32 + 8 bf16 Adam steps) and the BERT phase (``bert_base``,
b64 s128, 8 + 8 steps): ``{"lm": {dtype: ms a step}, "bert": {...}}``
(the mean of steps 2..8, CUDA events). ``quant_sparse`` runs the quant
and sparse phases (no kernel of this repo runs there): the INT8
ResNet-50 v1 b32 replay and eager ms beside the fp32 and bf16 replays,
the Custom-head ``Module`` step, and the Avazu-width sparse step. Prints
one line per checkout, ``AB <tree> {...}``, then the card's name and
power limit. Exits non-zero without a CUDA device or when a phase fails.
"""
import argparse
import json
import os
import subprocess
import sys

_CHILD = """
import argparse, json, os, sys
root = sys.argv[1]
os.chdir(root)
sys.path.insert(0, root)
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke as cs
args = argparse.Namespace(seed=0, profile=False, out=None)
if sys.argv[2] == "train":
    from mxnet_tpu_torch import _build
    _build.build(cs.SOURCES)
    tr = cs.train_phase(args, torch)
    bt = cs.bert_phase(args, torch)
    res = {"lm": {d: tr[d]["step_ms_mean"] for d in ("float32", "bfloat16")},
           "bert": {d: bt[d]["step_ms_mean"]
                    for d in ("float32", "bfloat16")}}
else:
    q = cs.quant_phase(args, torch)
    sp = cs.sparse_phase(args, torch)
    res = {k: q["int8"][k] for k in ("int8_replay_ms", "int8_eager_ms",
                                     "fp32_replay_ms", "bf16_replay_ms")}
    res["custom_step_ms"] = q["custom"]["step_ms"]
    res["sparse_step_ms"] = sp["linear"]["step_ms"]
print("AB", root, json.dumps(res), flush=True)
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", choices=("train", "quant_sparse"),
                    default="train")
    ap.add_argument("trees", nargs="+")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 2
    for tree in args.trees:
        res = subprocess.run([sys.executable, "-c", _CHILD,
                              os.path.abspath(tree), args.phases],
                             capture_output=True, text=True)
        lines = [l for l in res.stdout.splitlines() if l.startswith("AB ")]
        if res.returncode or not lines:
            print(res.stdout[-2000:] + res.stderr[-2000:], file=sys.stderr)
            return 1
        print(lines[-1], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
