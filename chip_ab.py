"""Two checkouts' training step times, in one call on one card.

    python3 chip_ab.py TREE [TREE ...]

For each checkout in turn (give each twice, in the order parent, change,
change, parent), a new process imports that checkout's ``chip_smoke.py``,
builds its kernels and runs its training phase (``transformer_lm_base``,
b32 s512, 8 fp32 + 8 bf16 Adam steps) and its BERT phase (``bert_base``,
b64 s128, 8 + 8 steps), with every check those phases make. Prints one
line per checkout: ``AB <tree> {"lm": {dtype: ms a step}, "bert":
{...}}`` (the mean of steps 2..8, CUDA events), then the card's name and
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
from mxnet_tpu_torch import _build
_build.build(cs.SOURCES)
args = argparse.Namespace(seed=0, profile=False, out=None)
tr = cs.train_phase(args, torch)
bt = cs.bert_phase(args, torch)
print("AB", root, json.dumps({
    "lm": {d: tr[d]["step_ms_mean"] for d in ("float32", "bfloat16")},
    "bert": {d: bt[d]["step_ms_mean"] for d in ("float32", "bfloat16")}}),
    flush=True)
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 2
    for tree in args.trees:
        res = subprocess.run([sys.executable, "-c", _CHILD,
                              os.path.abspath(tree)],
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
