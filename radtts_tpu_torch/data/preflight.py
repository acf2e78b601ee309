"""The dataset preflight, `python -m radtts_tpu_torch.data` (data/
__main__.py): the port of the repository's data.py (same flags, same
output).

It iterates the training and validation sets of a config (data/dataset.py:
Data), which validates the filelists and audio and warms the on-disk caches
the trainer reads: the beta-binomial attention priors and the pYIN f0 of
every utterance, under data_config.betabinom_cache_path, the same files the
JAX package writes. pYIN is numpy-bound, so with -j above 1 the utterances
fan out over a spawn pool, each worker with a Data of its own; the caches
are keyed per utterance, so the workers never write the same file. The
workers' functions live here, not in data/__main__.py: a spawned worker
does not import a package's __main__ module, so it could not unpickle
them from there.

    python -m radtts_tpu_torch.data -c configs/config_ljs_dap.json \\
        [-p data_config.betabinom_cache_path=cache] [-j 8]
"""

import argparse
import json
import multiprocessing
import os

from radtts_tpu_torch.config import update_params
from radtts_tpu_torch.data.dataset import data_factory

_DATASET = None


def _init_worker(data_config, files_key, speaker_ids):
    global _DATASET
    _DATASET = data_factory(data_config, files_key, speaker_ids)


def _warm(i):
    _DATASET[i]
    return i


def build_parser():
    parser = argparse.ArgumentParser(prog="python -m radtts_tpu_torch.data")
    parser.add_argument('-c', '--config', type=str,
                        help='JSON file for configuration')
    parser.add_argument('-p', '--params', nargs='+', default=[])
    parser.add_argument('-j', '--jobs', type=int,
                        default=min(8, os.cpu_count() or 1),
                        help='worker processes for cache warming')
    return parser


def main(argv=None):
    """Warm the caches of the config's training and validation sets; prints
    i/n for each utterance as data.py does. Returns the sets' sizes."""
    args = build_parser().parse_args(argv)
    with open(args.config) as f:
        config = json.load(f)
    update_params(config, args.params)
    print(config)

    data_config = config["data_config"]
    trainset = data_factory(data_config, "training_files")
    valset = data_factory(data_config, "validation_files",
                          trainset.speaker_ids)
    sizes = []
    for dataset, files_key in ((trainset, "training_files"),
                               (valset, "validation_files")):
        n = len(dataset)
        sizes.append(n)
        if args.jobs <= 1 or n < 2:
            for i in range(n):
                dataset[i]
                print("{}/{}".format(i, n))
            continue
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(min(args.jobs, n), _init_worker,
                      (data_config, files_key,
                       trainset.speaker_ids)) as pool:
            for i in pool.imap_unordered(_warm, range(n), chunksize=4):
                print("{}/{}".format(i, n))
    return sizes
