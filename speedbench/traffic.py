"""The one traffic generator: a mix is a data file, speedbench/traffic/
<name>.json, of parameters that this module reads.

Keys of a mix:
  loop        "closed": one synthesize call after another, `batch` texts
              each, no think time (the only loop so far).
  texts       a file of speedbench/traffic/, one text a line.
  pool        the texts of a run, drawn once from `texts` with `pool_seed`
              (without replacement) and cut into batches once; every seed
              runs the same batches in its own order, repeated, so that
              every seed does the same work and the set-up can warm every
              shape the window meets.
  speaker, knobs   the speaker and the synthesize() keyword arguments.
  check       {"dispatches": n}: how many synthesize calls the reference
              recomputes after the window (the longest text's, the
              largest batch's, the rest drawn from the seed).
  trace_calls  how many of the window's calls a traced run's device
              trace covers.
"""

import json
import os

import numpy as np

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "traffic")


def load_mix(name):
    with open(os.path.join(HERE, f"{name}.json")) as f:
        return json.load(f)


def load_texts(mix):
    with open(os.path.join(HERE, mix["texts"]), encoding="utf-8") as f:
        return [line.rstrip("\n") for line in f if line.strip()]


def _rng(seed):
    return np.random.default_rng(int(seed) % 2 ** 64)


def closed_batches(mix, seed):
    """The batches of a closed-loop run, in order (the window repeats the
    list; the set-up runs it once to warm every shape)."""
    if mix["loop"] != "closed":
        raise ValueError(f"loop {mix['loop']!r}")
    texts = load_texts(mix)
    pool = _rng(mix["pool_seed"]).choice(len(texts), mix["pool"],
                                         replace=False)
    b = mix["batch"]
    batches = [[texts[i] for i in pool[k:k + b]]
               for k in range(0, len(pool) - b + 1, b)]
    return [batches[i] for i in _rng(seed).permutation(len(batches))]
