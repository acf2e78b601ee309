"""Time the PyTorch/CUDA port's MRF kernels at HiFi-GAN v1's widths and
its resident AR scan in two checkouts of the repository, in turns (parent,
change, change, parent), one process a turn, on the current card:
csrc/mrf_tc.cu (3xTF32) and csrc/mrf_tf32.cu (one pass) at v1's serving
and training stages, and ar_scan at (1, 608), one AR flow of
config_ljs_agap.json's f0 model.

    python scripts/ab_torch_kernels.py --parent DIR [--change DIR] [--rounds N]

DIR is the root of a checkout (for example the parent commit's `git
archive` unpacked under build/); --change defaults to this checkout. Each
turn imports its checkout's port and chip_smoke.py helpers, builds the
kernels from its own sources, times each shape (chip_smoke.cuda_ms: the
median of 10 CUDA-event timings) and prints one JSON line; --rounds
repeats the four turns. The last line sums up by shape: each checkout's
times and change / parent of their medians. Needs a CUDA card; imports no
JAX.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def turn(root):
    """One checkout's times: {key: ms}."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from radtts_tpu_torch.ops import ar_scan as ar_mod
    from radtts_tpu_torch.ops import mrf as mrf_mod

    assert os.path.dirname(os.path.abspath(cs.__file__)) == root
    dev = torch.device("cuda", 0)
    times = {}
    with torch.no_grad():
        for route, passes in (("tc", 3), ("tf32", 1)):
            for shape in cs.STAGES + cs.TRAIN_STAGES:
                gen = torch.Generator(device=dev).manual_seed(0)
                x = torch.randn(*shape, device=dev, generator=gen)
                w = cs.random_mrf_weights(shape[2], dev, gen)
                times[f"{route} {tuple(shape)}"] = cs.cuda_ms(
                    lambda: mrf_mod.mrf_cuda(x, w, route=route,
                                             passes=passes))
        step = cs.ar_step_at_width("quadratic", dev)
        params, res, cproj = cs.ar_inputs(step, (1, cs.MAX_FRAMES), None,
                                          dev, seed=11)
        times[f"ar_scan (1, {cs.MAX_FRAMES})"] = cs.cuda_ms(
            lambda: ar_mod.ar_scan(params, res, cproj))
    return times


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent")
    ap.add_argument("--change", default=HERE)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        print(json.dumps(turn(os.path.abspath(args.turn))), flush=True)
        return 0
    if not args.parent:
        ap.error("--parent is required")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    trees = {"parent": os.path.abspath(args.parent),
             "change": os.path.abspath(args.change)}
    runs = {"parent": [], "change": []}
    for name in ("parent", "change", "change", "parent") * args.rounds:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--turn",
             trees[name]], cwd=trees[name], capture_output=True, text=True)
        if out.returncode != 0:
            sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
            return 1
        times = json.loads(out.stdout.strip().splitlines()[-1])
        runs[name].append(times)
        print(json.dumps({"turn": name, "card": card, "ms": times}),
              flush=True)
    summary = {}
    for key in runs["parent"][0]:
        p = [r[key] for r in runs["parent"]]
        c = [r[key] for r in runs["change"]]
        summary[key] = {"parent_ms": p, "change_ms": c,
                        "change_over_parent": statistics.median(c)
                        / statistics.median(p)}
    print(json.dumps({"card": card, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
