"""Text -> waveform inference CLI of the PyTorch port: the repository's
inference.py with the same flags, config JSONs, filelists and output files,
on one CUDA device (or the CPU with --device cpu), or on --data_parallel N
replicas.

    python -m radtts_tpu_torch.inference -c CONFIG -r RADTTS_CKPT \\
        -v HIFIGAN_CKPT -k HIFIGAN_CONFIG -t TEXT_FILE -s SPEAKER \\
        [-o results] [--batch_size N] [--long_text_chunk N] [--device cpu]

-r takes a reference torch checkpoint ({'state_dict': ...}) or the JAX
package's .npz. Each line of the text file (lines starting with '#' are
skipped) gives one wav, peak-normalised; --long_text_chunk splits long
lines at sentence boundaries and joins the chunks' audio with
--chunk_gap_ms of silence.

--use_amp runs the durations and decode stages' bf16 regions
(radtts_tpu_torch/ops/amp.py) and --weight_dtype bfloat16 stores the RADTTS
conv kernels in bf16, as the JAX CLI's flags do; the vocoder stays fp32.
--matmul_precision high or default lets cuBLAS and cuDNN use TF32 outside
the fp32 islands (the text encoder, the inverse 1x1 convs, the STFTs), and
default also runs the tensor-core MRF in one TF32 pass
(radtts_tpu_torch/ops/precision.py); highest, the default, is fp32.
--data_parallel N splits each batch over N replicas of the model, vocoder
and denoiser, one on each of the first N CUDA devices (N on the CPU with
--device cpu), as the JAX CLI shards it over N devices (synthesizer.py);
fewer visible devices are an error. --aot_dir (the XLA executable store)
is accepted and has no effect.
"""

import argparse
import json
import os

import numpy as np

from radtts_tpu_torch.config import update_params
from radtts_tpu_torch.text.chunking import split_text_to_chunks
from radtts_tpu_torch.text.processing import lines_to_list


def add_port_flags(parser):
    """The flags both CLIs share with the JAX ones that the port handles
    its own way (see refuse_unsupported), and --device."""
    parser.add_argument("--data_parallel", default=1, type=int,
                        help="split each batch over this many replicas, "
                             "one on each of the first N CUDA devices (N "
                             "on the CPU with --device cpu); batches pad "
                             "to a multiple of N")
    parser.add_argument("--weight_dtype", default="auto",
                        choices=["auto", "float32", "bfloat16"],
                        help="bfloat16 stores the RADTTS conv kernels in "
                             "bf16; auto is float32")
    parser.add_argument("--aot_dir", default="",
                        help="the JAX package's XLA executable store; no "
                             "effect here")
    parser.add_argument("--use_amp", action="store_true",
                        help="run the bf16 regions (ops/amp.py)")
    parser.add_argument("--matmul_precision", default=None,
                        choices=["default", "high", "highest"],
                        help="'highest' (the default) is fp32; 'high' and "
                             "'default' allow TF32 in cuBLAS/cuDNN outside "
                             "the fp32 islands, 'default' also one-pass "
                             "TF32 in the MRF kernel")
    parser.add_argument("--device", default=None,
                        help="torch device; default CUDA, which must be "
                             "present ('cpu' runs the plain path)")


def refuse_unsupported(parser, args):
    """parser.error (exit 2) on a flag the port cannot honour; one line
    for --aot_dir, which has no effect."""
    if args.data_parallel < 1:
        parser.error(f"--data_parallel {args.data_parallel}: at least 1")
    if args.aot_dir:
        print(f"--aot_dir {args.aot_dir}: no effect (XLA only)", flush=True)


def infer(synth, text_list, speaker, speaker_text, speaker_attributes,
          sigma, sigma_tkndur, sigma_f0, sigma_energy, token_dur_scaling,
          denoising_strength, n_takes, output_dir, plot, batch_size=1,
          long_text_chunk=0, chunk_gap_ms=120.0):
    """Synthesize every line of text_list (skipping '#' lines) and write
    one wav per line and take; returns the paths written."""
    sr = synth.sampling_rate
    os.makedirs(output_dir, exist_ok=True)

    items = []   # (line_idx, part_idx, n_parts, text)
    for i, t in enumerate(text_list):
        if t.startswith("#"):
            continue
        parts = [t]
        if long_text_chunk and long_text_chunk > 0:
            parts = split_text_to_chunks(
                t, lambda s: len(synth.encode(s)), long_text_chunk)
            if len(parts) > 1:
                print(f"{i}: split into {len(parts)} chunks "
                      f"(<= {long_text_chunk} tokens each)")
        items.extend((i, p, len(parts), text)
                     for p, text in enumerate(parts))
    gap = np.zeros(int(sr * chunk_gap_ms / 1000.0), np.float32)
    pending = {}  # (line_idx, take) -> [part wavs]
    written = []
    for b0 in range(0, len(items), max(1, batch_size)):
        chunk = items[b0:b0 + max(1, batch_size)]
        for i, p, n_parts, text in chunk:
            tag = f" [part {p + 1}/{n_parts}]" if n_parts > 1 else ""
            print(f"{i}/{len(text_list)}{tag}: {text}")

        for take in range(n_takes):
            wavs, aux = synth.synthesize(
                [text for _, _, _, text in chunk], speaker,
                speaker_text=speaker_text,
                speaker_attributes=speaker_attributes, sigma=sigma,
                sigma_tkndur=sigma_tkndur, sigma_f0=sigma_f0,
                sigma_energy=sigma_energy,
                denoising_strength=denoising_strength)

            from scipy.io.wavfile import write
            for j, (i, p, n_parts, _) in enumerate(chunk):
                wav = wavs[j]
                suffix_path = ("{}_{}_{}_durscaling{}_sigma{}_sigmatext{}_"
                               "sigmaf0{}_sigmaenergy{}").format(
                    i, take, speaker, token_dur_scaling, sigma,
                    sigma_tkndur, sigma_f0, sigma_energy)
                if plot:
                    # per part, before the join below: a chunked line gets
                    # one features PNG per chunk, named _partK
                    import matplotlib
                    matplotlib.use("Agg")
                    import matplotlib.pylab as plt
                    fig, axes = plt.subplots(2, 1, figsize=(10, 6))
                    axes[0].plot(aux["f0"][j], label="f0")
                    axes[1].plot(aux["energy_avg"][j], label="energy_avg")
                    for ax in axes:
                        ax.legend(loc="best")
                    plt.tight_layout()
                    part_tag = f"_part{p + 1}" if n_parts > 1 else ""
                    fig.savefig(f"{output_dir}/{suffix_path}{part_tag}"
                                "_features.png")
                    plt.close("all")

                if n_parts > 1:
                    # collect a chunked line's parts; join and normalise once
                    parts = pending.setdefault((i, take), [None] * n_parts)
                    parts[p] = wav
                    if any(w is None for w in parts):
                        continue
                    joined = [parts[0]]
                    for w in parts[1:]:
                        joined += [gap, w]
                    wav = np.concatenate(joined)
                    del pending[(i, take)]
                wav = wav / np.max(np.abs(wav))
                path = "{}/{}_denoised_{}.wav".format(
                    output_dir, suffix_path, denoising_strength)
                write(path, sr, wav.astype(np.float32))
                written.append(path)
    return written


def build_parser():
    parser = argparse.ArgumentParser(
        prog="python -m radtts_tpu_torch.inference")
    parser.add_argument('-c', '--config', type=str, required=True,
                        help='JSON file config')
    parser.add_argument('-k', '--config_vocoder', type=str, required=True,
                        help='vocoder JSON file config')
    parser.add_argument('-p', '--params', nargs='+', default=[])
    parser.add_argument('-r', '--radtts_path', type=str, required=True)
    parser.add_argument('-v', '--vocoder_path', type=str, required=True)
    parser.add_argument('-t', '--text_path', type=str, required=True)
    parser.add_argument('-s', '--speaker', type=str, required=True)
    parser.add_argument('--speaker_text', type=str, default=None)
    parser.add_argument('--speaker_attributes', type=str, default=None)
    parser.add_argument('-d', '--denoising_strength', type=float,
                        default=0.0)
    parser.add_argument('-o', "--output_dir", default="results")
    parser.add_argument("--sigma", default=0.8, type=float)
    parser.add_argument("--sigma_tkndur", default=0.666, type=float)
    parser.add_argument("--sigma_f0", default=1.0, type=float)
    parser.add_argument("--sigma_energy", default=1.0, type=float)
    parser.add_argument("--f0_mean", default=0.0, type=float)
    parser.add_argument("--f0_std", default=0.0, type=float)
    parser.add_argument("--energy_mean", default=0.0, type=float)
    parser.add_argument("--energy_std", default=0.0, type=float)
    parser.add_argument("--token_dur_scaling", default=1.00, type=float)
    parser.add_argument("--n_takes", default=1, type=int)
    parser.add_argument("--batch_size", default=1, type=int,
                        help="synthesize this many lines per batch "
                             "(padded to 16-token buckets)")
    parser.add_argument("--long_text_chunk", default=0, type=int,
                        help="split lines longer than this many encoded "
                             "tokens at sentence boundaries, synthesize "
                             "the chunks (batched), and rejoin the audio; "
                             "0 disables")
    parser.add_argument("--chunk_gap_ms", default=120.0, type=float,
                        help="silence inserted between rejoined chunks")
    parser.add_argument("--plot", action="store_true")
    parser.add_argument("--seed", default=1234, type=int)
    add_port_flags(parser)
    return parser


def main(argv=None):
    """Run the CLI on argv (default sys.argv[1:]); returns the wav paths
    written."""
    from radtts_tpu_torch.synthesizer import Synthesizer

    parser = build_parser()
    args = parser.parse_args(argv)
    refuse_unsupported(parser, args)
    with open(args.config) as f:
        config = json.load(f)
    update_params(config, args.params)

    synth = Synthesizer(
        config, args.radtts_path, args.vocoder_path, args.config_vocoder,
        seed=args.seed, token_dur_scaling=args.token_dur_scaling,
        f0_mean=args.f0_mean, f0_std=args.f0_std,
        energy_mean=args.energy_mean, energy_std=args.energy_std,
        use_amp=args.use_amp, weight_dtype=args.weight_dtype,
        matmul_precision=args.matmul_precision,
        data_parallel=args.data_parallel, device=args.device)
    print(f"Loaded checkpoint '{args.radtts_path}'")
    return infer(synth, lines_to_list(args.text_path), args.speaker,
                 args.speaker_text, args.speaker_attributes, args.sigma,
                 args.sigma_tkndur, args.sigma_f0, args.sigma_energy,
                 args.token_dur_scaling, args.denoising_strength,
                 args.n_takes, args.output_dir, args.plot,
                 batch_size=args.batch_size,
                 long_text_chunk=args.long_text_chunk,
                 chunk_gap_ms=args.chunk_gap_ms)


if __name__ == "__main__":
    main()
