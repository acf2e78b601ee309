"""RADTTS training CLI of the PyTorch port (the port of the repository's
train.py), run as

    python -m radtts_tpu_torch.train -c configs/config_ljs_decoder.json \\
        [-p train_config.output_directory=OUT ...] [--device cpu]

It reads the same config JSONs and -p dot-path overrides, writes config.json,
checkpoints OUT/model_<iteration> and (where tensorboardX imports) its
logs to train_config.output_directory, and prints one line per step as the
JAX trainer does. It runs on CUDA unless --device names another device
(cpu). train_config.use_amp runs the forward's bf16 regions
(radtts_tpu_torch/ops/amp.py; a string from -p counts as true only when
it reads 1, true, yes or on); train_config.optim_state_dtype bfloat16
keeps the optimizer's moments in bf16. A non-empty
train_config.profile_dir writes a torch.profiler trace of iterations
profile_start_iter (5) to profile_start_iter + profile_n_iters (5 more)
there. With vocoder_checkpoint_path and vocoder_config_path naming files,
each validation writes audio samples (log_decoder_samples,
log_attribute_samples) to the logs.

More than one device (parallel/mesh.py): launch WORLD_SIZE processes with
RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT (and LOCAL_RANK) in their
environment, as torchrun or the reference's torch.distributed.launch
--use_env set them; each rank runs on cuda:(LOCAL_RANK % device_count),
or the CPU with --device cpu. The ranks form a (WORLD_SIZE / n_model,
n_model) mesh: data parallelism over the first axis, each data rank
loading train_config.batch_size rows, and with -p dist_config.n_model=N
tensor parallelism over the decoder WNs' channels on the second. Errors,
as the JAX trainer's asserts: an n_model that does not divide WORLD_SIZE,
a batch_size that the data axis does not divide.
"""

import argparse
import json
import os

from radtts_tpu_torch.config import update_params


def _flag(value):
    """A config flag that may arrive as a string from -p (literal_eval
    leaves 'false' a string)."""
    if isinstance(value, str):
        return value.strip().lower() in ("1", "true", "yes", "on")
    return bool(value)


def refusal(config):
    """The error for the first option the port does not have or the
    first layout the JAX trainer asserts against, or None."""
    tc = config["train_config"]
    if str(tc.get("optim_state_dtype") or "float32") not in ("float32",
                                                              "bfloat16"):
        return (f"train_config.optim_state_dtype="
                f"{tc['optim_state_dtype']} is not supported: float32 or "
                "bfloat16")
    n_model = int(config.get("dist_config", {}).get("n_model", 1))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if n_model < 1 or world % n_model:
        return (f"dist_config.n_model={n_model} does not divide "
                f"WORLD_SIZE={world}")
    n_data = world // n_model
    if n_data > 1 and int(tc["batch_size"]) % n_data:
        return (f"train_config.batch_size={tc['batch_size']} is not "
                f"divisible by {n_data} data shards")
    return None


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-c", "--config", type=str, required=True,
                    help="JSON file for configuration")
    ap.add_argument("-p", "--params", nargs="+", default=[])
    ap.add_argument("--device", type=str, default=None,
                    help="torch device; CUDA when not given (with "
                         "WORLD_SIZE > 1, cuda:LOCAL_RANK)")
    return ap


def main(argv=None):
    """Parse, check and train; returns the trainer's per-step records."""
    from radtts_tpu_torch.train.trainer import train

    parser = build_parser()
    args = parser.parse_args(argv)
    with open(args.config) as f:
        config = json.load(f)
    update_params(config, args.params)
    print(config)
    mc, dc = config["model_config"], config["data_config"]
    if "n_aug_dims" in mc and "aug_probabilities" in dc:
        assert mc["n_aug_dims"] >= len(dc["aug_probabilities"])
    error = refusal(config)
    if error:
        parser.error(error)
    tc = dict(config["train_config"],
              use_amp=_flag(config["train_config"].get("use_amp", False)))
    n_model = int(config.get("dist_config", {}).get("n_model", 1))
    if int(os.environ.get("WORLD_SIZE", "1")) == 1:
        return train(config, device=args.device, **tc)
    import torch.distributed as dist

    from radtts_tpu_torch.parallel.mesh import (init_distributed,
                                                launch_env, local_device)
    from radtts_tpu_torch.synthesizer import resolve_device

    device = resolve_device(args.device)
    if args.device is None:
        device = local_device(launch_env()[2])
    mesh = init_distributed(device, n_model)
    try:
        return train(config, device=device, mesh=mesh, **tc)
    finally:
        dist.destroy_process_group()
