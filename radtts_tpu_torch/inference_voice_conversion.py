"""Voice-conversion CLI of the PyTorch port: the repository's
inference_voice_conversion.py with the same flags, config JSONs, filelists
and output files, on one CUDA device (or the CPU with --device cpu).

    python -m radtts_tpu_torch.inference_voice_conversion -r RADTTS_CKPT \\
        -c CONFIG -v HIFIGAN_CKPT -k HIFIGAN_CONFIG -o OUT [-n 5] \\
        [--predict_features [--filter_invalid]] [--device cpu]

For each utterance of the config's validation filelist (at most -n of
them, in the loader's order; --shuffle visits them in the order the JAX
loader does for --seed): the training forward on its mel with binarized
attention (MAS: csrc/mas.cu on the card) gives the durations,
floor(sum(attn) + 0.5) per token; then the decode at a frame budget that
is a multiple of 16 * n_group_size, with the utterance's own f0, energy
and voiced mask injected (renormalized by --f0_mean/--f0_std), or, with
--predict_features, the attribute predictors' (--filter_invalid draws
again while f0 or energy is all zero, NaN, or above the training set's
f0_max or 1.0); then the vocoder and the denoiser. Each take writes
OUT/<name>_<take>_sid<speaker>_sigma<sigma>.wav, and with the flags the
mel (_mel.npy, (1, n_mel, T)), the features (_f0.npy, f0 below f0_min
zeroed; _energy.npy) and a plot (.png). A take whose
..._denoised.wav exists is skipped, as the JAX CLI does.

-r takes a reference torch checkpoint, the JAX package's .npz or the
port's training checkpoint. Noise comes from a torch.Generator seeded by
--seed. --use_amp runs the bf16 regions of the forward and the decode
(ops/amp.py), as the JAX CLI does; --weight_dtype bfloat16 stores the
RADTTS conv kernels in bf16 (the port's serving flag; the JAX CLI has no
such flag). --matmul_precision high or default allows TF32 outside the
fp32 islands, as the inference CLI's (ops/precision.py). The injected
features are zero-padded to the frame budget where the collated batch is
shorter (the frames past the utterance are masked).
"""

import argparse
import json
import os

import numpy as np
import torch

from radtts_tpu_torch.config import update_params


def is_feature_invalid(x, max_val):
    x = np.asarray(x)
    return bool(np.isnan(x).any() or x.sum() == 0 or x.max() > max_val)


def _frame_budget(n, g, multiple=16):
    m = multiple * g
    return ((int(n) + m - 1) // m) * m


def _frames(a, n, device):
    """(1, T) numpy -> (1, n) float32 tensor, cut or zero-padded."""
    a = np.asarray(a, np.float32)[:, :n]
    if a.shape[1] < n:
        a = np.pad(a, ((0, 0), (0, n - a.shape[1])))
    return torch.as_tensor(a, device=device)


@torch.no_grad()
def infer(radtts_path, radtts_config_path, vocoder_path,
          vocoder_config_path, n_samples, sigma, use_amp, seed, output_dir,
          denoising_strength, params_overrides, shuffle, takes, save_mels,
          no_audio, predict_features, sigma_f0=1.0, sigma_energy=0.8,
          save_features=False, plot_features=False, f0_mean=0.0, f0_std=0.0,
          energy_mean=0.0, energy_std=0.0, filter_invalid=False,
          weight_dtype="auto", matmul_precision=None, device=None):
    """Run the conversion (the JAX CLI's infer, same arguments, plus
    weight_dtype, matmul_precision and device; the utterances run inside
    ops/precision.py:scope, after loading). Returns the wav paths
    written."""
    from radtts_tpu_torch.data.dataset import Data, DataCollate, DataLoader
    from radtts_tpu_torch.models.hifigan import denoiser_apply
    from radtts_tpu_torch.models.radtts import radtts_forward, radtts_infer
    from radtts_tpu_torch.ops import amp, precision
    from radtts_tpu_torch.ops.fold_norms import store_conv_weights
    from radtts_tpu_torch.synthesizer import Synthesizer, resolve_device
    from radtts_tpu_torch.train.checkpoint import load_radtts_for_inference
    from radtts_tpu_torch.vocoder_io import load_vocoder

    device = resolve_device(device)
    with open(radtts_config_path) as f:
        config = json.load(f)
    update_params(config, params_overrides)
    model_config = config["model_config"]
    data_config = config["data_config"]

    vocoder, denoiser = load_vocoder(vocoder_path, vocoder_config_path,
                                     device=device)
    os.makedirs(output_dir, exist_ok=True)

    print(f"Loading checkpoint '{radtts_path}'")
    model, _ = load_radtts_for_inference(radtts_path, model_config)
    if Synthesizer.resolve_weight_dtype(weight_dtype) == "bfloat16":
        store_conv_weights(model)
    model = model.to(device).eval().requires_grad_(False)
    print(f"Loaded checkpoint '{radtts_path}'")

    ignore_keys = ["training_files", "validation_files"]
    trainset = Data(data_config["training_files"],
                    **{k: v for k, v in data_config.items()
                       if k not in ignore_keys})
    data_config = dict(data_config)
    data_config["dur_max"] = 60
    valset = Data(data_config["validation_files"],
                  **{k: v for k, v in data_config.items()
                     if k not in ignore_keys},
                  speaker_ids=trainset.speaker_ids)
    loader = DataLoader(valset, 1, DataCollate(), shuffle=shuffle,
                        seed=seed, num_workers=1, drop_last=False)

    f0_max = trainset.f0_max
    energy_max = 1.0
    generator = torch.Generator(device).manual_seed(seed)
    g = model_config["n_group_size"]
    written = []

    def tensor(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    def convert(k, batch):
        filename = os.path.splitext(
            os.path.basename(batch["audiopaths"][0]))[0]
        f0_gt = batch["f0"].copy()
        energy_gt = batch["energy_avg"].copy()
        suffix_path = "sid{}_sigma{}".format(int(batch["speaker_ids"][0]),
                                             sigma)
        print("sample", k, filename)

        # ground-truth-mel forward with binarized attention -> durations
        with amp.scope(model, use_amp):
            outputs = radtts_forward(
                model, tensor(batch["mel"]), tensor(batch["speaker_ids"]),
                tensor(batch["text"]), tensor(batch["input_lengths"]),
                tensor(batch["output_lengths"]),
                binarize_attention_flag=True,
                attn_prior=tensor(batch["attn_prior"]),
                f0=tensor(batch["f0"]),
                energy_avg=tensor(batch["energy_avg"]),
                voiced_mask=tensor(batch["voiced_mask"]),
                p_voiced=tensor(batch["p_voiced"]))
        dur_target = torch.floor(outputs["attn"][0].sum(0) + 0.5)
        dur_target = dur_target.to(torch.int32)[None]
        total = int(dur_target.sum())
        max_frames = _frame_budget(total, g)

        speaker_ids = tensor(batch["speaker_ids"])
        text = tensor(batch["text"])

        for j in range(takes):
            audio_path = "{}/{}_{}_{}_denoised.wav".format(
                output_dir, filename, j, suffix_path)
            if os.path.exists(audio_path):
                print("skipping", audio_path)
                continue

            if predict_features:
                f0_bad, energy_bad = True, True
                while f0_bad or energy_bad:
                    with amp.scope(model, use_amp):
                        model_output = radtts_infer(
                            model, speaker_ids, text, sigma, max_frames,
                            dur=dur_target, sigma_f0=sigma_f0,
                            sigma_energy=sigma_energy, generator=generator)
                    f0 = model_output["f0"]
                    energy_avg = model_output["energy_avg"]
                    if filter_invalid:
                        f0_bad = is_feature_invalid(f0.cpu(), f0_max)
                        energy_bad = is_feature_invalid(energy_avg.cpu(),
                                                        energy_max)
                    else:
                        f0_bad = energy_bad = False
            else:
                with amp.scope(model, use_amp):
                    model_output = radtts_infer(
                        model, speaker_ids, text, sigma, max_frames,
                        dur=dur_target,
                        f0=_frames(batch["f0"], max_frames, device),
                        energy_avg=_frames(batch["energy_avg"], max_frames,
                                           device),
                        voiced_mask=_frames(batch["voiced_mask"],
                                            max_frames, device),
                        f0_mean=f0_mean, f0_std=f0_std,
                        energy_mean=energy_mean, energy_std=energy_std,
                        generator=generator)
                f0 = model_output["f0"]
                energy_avg = model_output["energy_avg"]

            mel = model_output["mel"][:, :total]

            if save_mels:
                np.save("{}/{}_{}_{}_mel".format(
                    output_dir, filename, j, suffix_path),
                    mel.cpu().numpy().transpose(0, 2, 1))

            if not no_audio:
                audio = denoiser_apply(denoiser, vocoder(mel),
                                       strength=denoising_strength)
                from scipy.io.wavfile import write
                wav = audio[0].cpu().numpy().astype(np.float32)
                path = "{}/{}_{}_{}.wav".format(
                    output_dir, filename, j, suffix_path)
                write(path, data_config["sampling_rate"], wav)
                written.append(path)

            if plot_features:
                import matplotlib
                matplotlib.use("Agg")
                import matplotlib.pylab as plt
                fig, axes = plt.subplots(2, 1, figsize=(8, 3))
                axes[0].plot(f0_gt[0], label="gt")
                axes[0].plot(f0.cpu().numpy()[0], label="pred")
                axes[1].plot(energy_gt[0], label="gt")
                axes[1].plot(energy_avg.cpu().numpy()[0], label="pred")
                plt.savefig("{}/{}_{}_{}.png".format(
                    output_dir, filename, j, suffix_path))
                plt.close("all")

            if save_features:
                f0_np = f0.cpu().numpy().copy()
                f0_np[f0_np < data_config["f0_min"]] = 0.0
                np.save("{}/{}_{}_{}_f0".format(
                    output_dir, filename, j, suffix_path), f0_np)
                np.save("{}/{}_{}_{}_energy".format(
                    output_dir, filename, j, suffix_path),
                    energy_avg.cpu().numpy())

    with precision.scope(matmul_precision):
        for k, batch in enumerate(loader):
            convert(k, batch)
            if k + 1 == n_samples:
                break
    loader.close()
    return written


def build_parser():
    parser = argparse.ArgumentParser(
        prog="python -m radtts_tpu_torch.inference_voice_conversion")
    parser.add_argument('-r', '--radtts_path', type=str)
    parser.add_argument('-c', '--radtts_config_path', type=str)
    parser.add_argument('-v', '--vocoder_path', type=str)
    parser.add_argument('-k', '--vocoder_config_path', type=str)
    parser.add_argument('-p', '--params', nargs='+', default=[])
    parser.add_argument('-n', '--n_samples', default=5, type=int)
    parser.add_argument("-s", "--sigma", default=0.8, type=float)
    parser.add_argument("--sigma_f0", default=1.0, type=float)
    parser.add_argument("--sigma_energy", default=1.0, type=float)
    parser.add_argument("--f0_mean", default=0.0, type=float)
    parser.add_argument("--f0_std", default=0.0, type=float)
    parser.add_argument("--energy_mean", default=0.0, type=float)
    parser.add_argument("--energy_std", default=0.0, type=float)
    parser.add_argument("--seed", default=1234, type=int)
    parser.add_argument("--use_amp", action="store_true")
    parser.add_argument("-o", '--output_dir', type=str)
    parser.add_argument("-d", "--denoising_strength", default=0.01,
                        type=float)
    parser.add_argument("--shuffle", action="store_true")
    parser.add_argument("--save_mels", action="store_true")
    parser.add_argument("--no_audio", action="store_true")
    parser.add_argument("--predict_features", action="store_true")
    parser.add_argument("--save_features", action="store_true")
    parser.add_argument("--plot_features", action="store_true")
    parser.add_argument("--filter_invalid", action="store_true")
    parser.add_argument('-t', '--takes', default=1, type=int)
    parser.add_argument("--matmul_precision", default=None,
                        choices=["default", "high", "highest"],
                        help="'highest' (the default) is fp32; 'high' and "
                             "'default' allow TF32 outside the fp32 "
                             "islands, 'default' also one-pass TF32 in the "
                             "MRF kernel")
    parser.add_argument("--weight_dtype", default="auto",
                        choices=["auto", "float32", "bfloat16"],
                        help="bfloat16 stores the RADTTS conv kernels in "
                             "bf16; auto is float32")
    parser.add_argument("--device", default=None,
                        help="torch device; default CUDA, which must be "
                             "present ('cpu' runs the plain path)")
    return parser


def main(argv=None):
    """Run the CLI on argv (default sys.argv[1:]); returns the wav paths
    written."""
    parser = build_parser()
    args = parser.parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    return infer(args.radtts_path, args.radtts_config_path,
                 args.vocoder_path, args.vocoder_config_path,
                 args.n_samples, args.sigma, args.use_amp, args.seed,
                 args.output_dir, args.denoising_strength, args.params,
                 args.shuffle, args.takes, args.save_mels, args.no_audio,
                 args.predict_features, args.sigma_f0, args.sigma_energy,
                 args.save_features, args.plot_features, args.f0_mean,
                 args.f0_std, args.energy_mean, args.energy_std,
                 args.filter_invalid, weight_dtype=args.weight_dtype,
                 matmul_precision=args.matmul_precision, device=args.device)


if __name__ == "__main__":
    main()
