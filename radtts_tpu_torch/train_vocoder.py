"""HiFi-GAN vocoder training CLI of the PyTorch port (the port of the
repository's train_vocoder.py).

It reads the radtts config for the filelists and audio parameters and the
HiFi-GAN config JSON the inference CLIs consume. Every checkpoint step it
writes g_<iteration>.pt, the generator in the reference's
{'generator': state_dict} format, and do_<iteration>.pt, the full state
(generator, both discriminators, both optimizers, the iteration) for
--resume. --resume also takes the JAX package's do_<iteration>.npz (its
train_vocoder.py's): the weights, both AdamW states (step counts and
moments) and so the lr schedule's position. It runs on CUDA unless
--device cpu; precision is pinned to fp32.

    python -m radtts_tpu_torch.train_vocoder -c configs/config_ljs_dap.json \\
        -k hifigan_config.json -o outdir [--warmstart hifigan.pt] \\
        [--steps 10000 --batch_size 16 --segment_size 8192] [--device cpu]
"""

import argparse
import json
import os
import time

import torch

from radtts_tpu_torch.config import update_params
from radtts_tpu_torch.convert import (element_map, optimizer_state_from_jax,
                                      vocoder_train_from_jax)
from radtts_tpu_torch.models.hifigan import (generator_from_reference,
                                             generator_to_reference)
from radtts_tpu_torch.synthesizer import resolve_device
from radtts_tpu_torch.train.checkpoint import (is_torch_checkpoint,
                                               load_checkpoint, opt_moments)
from radtts_tpu_torch.train.vocoder_trainer import (SegmentSampler,
                                                    make_optimizers,
                                                    make_vocoder_train_step,
                                                    vocoder_train_init)


def filelist_audio_paths(data_config, which="training_files"):
    paths = []
    for _, spec in data_config[which].items():
        basedir = spec["basedir"]
        audiodir = spec.get("audiodir", "")
        with open(os.path.join(basedir, spec["filelist"]),
                  encoding="utf-8") as f:
            for line in f:
                name = line.rstrip("\n").split("|")[0]
                paths.append(os.path.join(basedir, audiodir, name))
    return paths


def load_resume(path, models, optim_g, optim_d, h):
    """--resume: the models' and both optimizers' state from this CLI's
    do_<it>.pt or the JAX package's do_<it>.npz, whose optax AdamW states
    (chain position 0: count, mu, nu; 2: the schedule's count) become
    AdamW's step, exp_avg and exp_avg_sq, each moment through its
    parameter's layout change (convert.element_map); DecayedAdamW reads
    the schedule's position from the step. Returns the iteration."""
    if is_torch_checkpoint(path):
        device = next(models.parameters()).device
        state = torch.load(path, map_location=device)
        models.load_state_dict(state["models"])
        optim_g.load_state_dict(state["optim_g"])
        optim_d.load_state_dict(state["optim_d"])
        return int(state["iteration"])
    tree, meta = load_checkpoint(path)
    models.load_state_dict(vocoder_train_from_jax(tree, h).state_dict())
    emap = element_map(lambda t: vocoder_train_from_jax(t, h), tree)
    del tree
    states = opt_moments(path)
    for name, opt, wrap in (("g", optim_g, lambda m: {"gen": m}),
                            ("d", optim_d, lambda m: m)):
        adam, sched = states.get(f"{name}/0/"), states.get(f"{name}/2/")
        if adam is None or "mu" not in adam:
            raise ValueError(f"{path}: no AdamW state under opt/{name}/0/")
        if sched is not None and sched["count"] != adam["count"]:
            raise ValueError(f"{path}: opt/{name}: the schedule's count "
                             f"{sched['count']} is not AdamW's "
                             f"{adam['count']}")
        if adam["count"]:
            opt.load_state_dict(optimizer_state_from_jax(
                opt, models.named_parameters(), emap, adam["count"],
                wrap(adam["mu"]), wrap(adam["nu"]),
                step=lambda c: torch.tensor(float(c))))
    return int(meta["iteration"])


def train(args, config):
    """Run the training loop. Returns one record per iteration: the
    iteration, its wall milliseconds (sampling, step and the read-back of
    the losses, which waits for the card) and the five losses."""
    device = resolve_device(args.device)
    data_config = config["data_config"]
    with open(args.vocoder_config) as f:
        h = json.load(f)
    mel_kwargs = {k: data_config[k] for k in (
        "filter_length", "hop_length", "win_length", "n_mel_channels",
        "sampling_rate", "mel_fmin", "mel_fmax")}

    models = vocoder_train_init(h, seed=args.seed)
    if args.warmstart:
        ckpt = torch.load(args.warmstart, map_location="cpu")
        models["gen"] = generator_from_reference(ckpt["generator"], h)
        print(f"warmstarted generator from '{args.warmstart}'")
    models.to(device)
    optim_g, optim_d = make_optimizers(models, lr=args.lr,
                                       lr_decay=args.lr_decay,
                                       decay_every=args.decay_every)
    start_it = 0
    if args.resume:
        start_it = load_resume(args.resume, models, optim_g, optim_d, h)
        print(f"resumed full GAN state from '{args.resume}' "
              f"(iteration {start_it})")

    p_blur = float(h.get("gaussian_blur", {}).get("p_blurring", 0.0))
    step = make_vocoder_train_step(mel_kwargs, optim_g, optim_d,
                                   p_blurring=p_blur)
    sampler = SegmentSampler(filelist_audio_paths(data_config),
                             args.segment_size, seed=args.seed)
    os.makedirs(args.output_dir, exist_ok=True)

    history = []
    for it in range(start_it, args.steps):
        tic = time.perf_counter()
        # segments and blur draws are both keyed by the iteration, so a
        # --resume run continues the uninterrupted run's stream exactly
        audio = torch.from_numpy(
            sampler.sample(args.batch_size, step=it)).to(device)
        blur_rng = torch.Generator().manual_seed((args.seed + 1) * 2 ** 32
                                                 + it)
        metrics = {k: float(v) for k, v in
                   step(models, audio, blur_rng).items()}
        ms = (time.perf_counter() - tic) * 1e3
        history.append({"iteration": it, "ms": ms, **metrics})
        if it % args.log_interval == 0:
            print(f"iter {it} ({ms:.1f} ms) " + "  ".join(
                f"{k}: {v:.4f}" for k, v in sorted(metrics.items())),
                flush=True)
        if (it + 1) % args.steps_per_checkpoint == 0 or it + 1 == args.steps:
            g_path = os.path.join(args.output_dir, f"g_{it + 1:08d}.pt")
            torch.save({"generator": generator_to_reference(models["gen"])},
                       g_path)
            do_path = os.path.join(args.output_dir, f"do_{it + 1:08d}.pt")
            torch.save({"iteration": it + 1, "models": models.state_dict(),
                        "optim_g": optim_g.state_dict(),
                        "optim_d": optim_d.state_dict()}, do_path)
            print(f"saved {g_path} + {do_path}", flush=True)
    return history


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-c", "--config", type=str, required=True,
                    help="radtts JSON config (data_config: filelists/stft)")
    ap.add_argument("-k", "--vocoder_config", type=str, required=True)
    ap.add_argument("-p", "--params", nargs="+", default=[])
    ap.add_argument("-o", "--output_dir", type=str, required=True)
    ap.add_argument("--warmstart", type=str, default="",
                    help="reference {'generator': sd} checkpoint to start "
                         "from")
    ap.add_argument("--resume", type=str, default="",
                    help="do_*.pt full-state checkpoint (gen+discs+optims) "
                         "saved by this CLI, or the JAX package's "
                         "do_*.npz")
    ap.add_argument("--steps", type=int, default=10000)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--segment_size", type=int, default=8192)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--lr_decay", type=float, default=0.999)
    ap.add_argument("--decay_every", type=int, default=1000)
    ap.add_argument("--steps_per_checkpoint", type=int, default=2500)
    ap.add_argument("--log_interval", type=int, default=10)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device; CUDA when not given")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    with open(args.config) as f:
        config = json.load(f)
    update_params(config, args.params)
    return train(args, config)


if __name__ == "__main__":
    main()
