#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (radtts_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing a JSON or text line:
  1. device: the card's name and power limit, torch/CUDA versions, the
     pinned TF32 flags;
  2. build: nvcc of radtts_tpu_torch/csrc/mrf_tc.cu (twice: 3xTF32 and
     the one-pass -DMRF_TC_PASSES=1), csrc/mrf_tf32.cu, csrc/mrf_stack.cu,
     csrc/mrf.cu (run by name only: the "before" of the padded widths),
     csrc/mel.cu, csrc/mas.cu, csrc/ar_scan.cu and csrc/lstm.cu for
     sm_90a, all nine at once, with seconds
     and ptxas register/spill lines; then each kernel's shared memory per
     block;
  3. MRF kernels vs plain: ops/mrf.py:mrf against mrf_plain on the card,
     within 1e-4 * max|plain| (fp32 sums in another order, TF32 off; the
     tensor-core kernel in 3xTF32), on the route mrf_route(C) names:
     csrc/mrf_tc.cu at all four HiFi-GAN v1 widths (the serving stages
     C=256, 128, 64, 32; the training discriminator pass's (16, 256, 256),
     (16, 2048, 128), (16, 4096, 64), (16, 8192, 32); ragged (2, 997, C)),
     csrc/mrf_stack.cu at HiFi-GAN V2's last stages (1, 77824, 16) and
     (1, 155648, 8), ragged (2, 997, 16) and (2, 997, 8), and T below one
     tile (2, 50, 16); csrc/mrf_tc.cu at (2, 997, 192), a multiple of 64
     that 128 does not divide.
     With the kernel's, the plain version's and the cuDNN conv chain's
     times, the launch grid, the bound at the 3xTF32 rate beside the
     fp32-FMA one, and the 18-launch chain's activation-bytes floor; at
     C=64, 32, 16 and 8 also csrc/mrf.cu's time on the same inputs
     (route="conv", the kernel those stages ran before). Then the
     tensor-core kernel's tile shapes at the v1 serving stages and the
     stack kernel's tile rows at the V2 ones; then csrc/mrf_tc.cu's
     one-pass build (route="tc", passes=1) against mrf_plain(passes=1) at
     the four v1 serving stages, timed beside the 3xTF32 build, the plain
     version, the cuDNN chain at TF32 and the bound at the TF32 rate; then
     csrc/mrf_tf32.cu (route "tf32") against mrf_plain(passes=1) at
     the serving, training and ragged shapes and (2, 997, 192), timed at
     the first two in
     turns with that build ("before") and beside the same yardsticks and
     the chain's bytes floor, and its tile shapes swept at the serving
     stages; then (mrf_padded) the widths csrc/mrf.cu took before,
     on the tensor cores at ops/mrf.py:padded_width(C) at both passes
     (csrc/mrf_tc.cu, csrc/mrf_tf32.cu; 18 launches of the route's kernel
     and none of csrc/mrf.cu counted a call): (1, 38912, 96), (1, 77824,
     48), (1, 155648, 24), (1, 38912, 160), ragged (2, 997, 40) and a C=16
     stage of 5 resblocks, each within 1e-4 * max of mrf_plain(passes),
     the first four timed beside csrc/mrf.cu on the same inputs (before),
     the plain version, the cuDNN chain at the same precision and the
     bound;
  4. mel kernel vs plain: ops/mel.py:mel (the shared-memory real FFT)
     against mel_plain at (16, 8192), (1, 155648) and (3, 9001): log-mel
     within 1e-3 (fp32 sums in another order, amplified by the log near
     the 1e-5 clamp), the gradient through MelFunction within 1e-5 *
     max|plain grad|, with the kernel's, the plain version's and the cuFFT
     composite's times, the bound and the kernel's own FLOP; then the MRF
     kernel must refuse a call whose output would need a gradient;
  5. serving path: a Synthesizer at the flagship config_ljs_dap.json width
     plus HiFi-GAN v1 with random weights (seed 0; WN end convs perturbed
     to sd 0.002) answers three requests (one text, a batch of three, one
     with denoising_strength=0.1), then a fixed-duration 608-frame
     decode + vocoder + denoiser runs with stage times and the RTF.
     mrf.tc_launches (csrc/mrf_tc.cu) must grow by 72 per generator call,
     mrf.stack_launches and mrf.launches (csrc/mrf.cu) by 0. Outputs must
     be finite and of the expected lengths; the decode and the vocoder of
     the 608-frame utterance are also held against the CPU plain path;
     then the same Synthesizer at each --matmul_precision
     (highest, high, default): a request, the 608-frame utterance's stage
     times and RTF, its mel's and waveform's distance from highest's,
     counted from 0 (72 launches a generator call of mrf_tc at highest
     and high, of mrf_tf32 at default), the
     utterance once more at
     default on csrc/mrf_tc.cu's one-pass build (mel and waveform at
     most 1.5x its distance from highest); and the utterance's
     counted FLOP by stage (ops/flops.py) over its time;
  5b. AR scan kernels vs plain: ops/ar_scan.py:ar_scan against
     ar_scan_plain on the card at AR_SHAPES: one AR step of
     config_ljs_agap.json's f0 model at its published width, its zero-init
     head drawn at sd 0.02, at (1, 608), ragged (3, 608) with valid
     lengths 608/411/97, ragged (8, 608) and (16, 608), and (2, 96) with
     the linear-spline and the affine heads: csrc/ar_scan.cu's resident
     kernel (the route ar_scan_plan names, asserted) within 1e-4 *
     max|plain|, and the barrier kernel on the same inputs ("before"), with
     both times, the plain version's, the bound and us per frame; the
     resident kernel's block count swept at (1, 608); a second step of
     other weights, built where the first was freed, against its own
     plain version; then f0's and energy's steps paired in one launch at
     (1, 608), (8, 608) ragged and (16, 608) against the two launched
     apart and against plain, and at (24, 96), where the planner names a
     launch each (asserted); steps of H = 1024 and 1022 (padded to 1024),
     whose weights do not fit the blocks' shared memory, on the split
     route (asserted: one resident-kernel launch, no barrier-kernel
     launch; the rows that do not fit read from L2), timed beside the
     barrier kernel on the same inputs (before), the plain version, the
     bound and the chain floor (overflow bytes over the L2 read rate plus
     the handoff probe); the
     handoff probe (608 x 6 empty phases on the resident grid, joined by
     the handoff and by the barrier kernel's grid barrier: the chain
     floor); and the frame traced at (1, 608), one flow and the pair
     (each phase's rows,
     handoff and load, the attribute LSTM and the inverse, in us); and
     a step with bf16-stored head kernels on both kernels against the
     repaired plain scan (the head's inputs rounded to bf16; within
     1e-3 * max, at most 4 outputs past 1e-4 * max, the mean distance
     at most 0.1 of that from the unrounded scan), and both kernels with
     the rounding flag cleared, which that check must reject;
  5bb. the LSTM kernel vs plain: csrc/lstm.cu (ops/lstm.py:lstm_cuda, the
     route MaskedLSTM takes, asserted) at LSTM_SHAPES, the benchmark
     cells' masked BiLSTMs at batch 16 with ragged lengths, against
     lstm_plain within 1e-4 * max|plain| and zero past each length,
     beside the cuDNN packed path on the same inputs (before), with the
     plain version's time, the FLOP bound and the chain floor (the
     handoff probe x T);
  5c. BGAP and AGAP serving: config_ljs_bgap.json and
     config_ljs_agap.json at their published widths with HiFi-GAN v1,
     random weights (seed 0; WN end convs at sd 0.002, the flows'
     zero-init last layers at sd 0.02) answer one request each, counted
     from 0 (ar_scan 2 for AGAP: f0's and energy's flows paired; 0 for
     BGAP; mrf_tc 72), then the 608-frame
     utterance with stage times and the RTF, and f0, energy and mel held
     against the CPU plain path from the same z_f0, z_energy, residual and
     a seeded voiced mask (within 1e-3; f0 relative to its max);
  5d. mixed precision serving: the flagship Synthesizer with use_amp,
     weight_dtype="bfloat16" and both, beside fp32, one request each and
     the 608-frame utterance (fixed durations, a seeded residual): each
     variant's mel distance from the card's fp32 mel at most 3x the CPU's
     own on the same weights (or 1e-3); the bf16 regions left in fp32 and
     run in bf16 inside; stage times and the RTF; the resident conv-kernel
     bytes; a profiled AMP decode (which LSTM kernels ran); mrf_tc 72 per
     vocoder call;
  5e. model options served at published widths with HiFi-GAN v1:
     config_ljs_dap.json with its duration, f0 and energy DAPs on the
     FFTransformer (use_transformer set through update_params, as -p
     sets it) and with a plain-W decoder (matrix_decomposition ""): one
     request counted from 0 (mrf_tc 72), the 608-frame utterance's
     stage times and RTF (the FFTransformer's attributes stage beside
     the ConvLSTM DAP's in the same call), the decode against the CPU
     within 1e-3 and the vocoder within 1e-3 * max; and
     config_ljs_agap.json with weight_dtype="bfloat16" beside fp32: one
     request counted (ar_scan 2, mrf_tc 72), the bf16 mel's distance
     from the card's fp32 at most 3x the CPU's own (or 1e-3), the RTF
     and the resident conv-kernel bytes;
  5f. data-parallel serving (serve_dp2_608): the flagship Synthesizer at
     data_parallel=2 with both replicas on this card, against
     data_parallel=1 from the same seed: four texts whose batch budget is
     608 frames give the same durations and audio within 1e-3 * max,
     three texts three wavs; mrf_tc 72 in each replica's vocoder call;
     the wall time of both settings;
  6. HiFi-GAN V2 serving: the generator of the public config_v2.json (v1
     with upsample_initial_channel 128; random weights, seed 5) on a
     seeded 608-frame mel, stages (1, 4864, 64), (1, 38912, 32), (1, 77824,
     16), (1, 155648, 8): vocoder ms (median of 3, synchronised), device
     time by kernel under the profiler; per generator call
     mrf.tc_launches must grow by 36, mrf.stack_launches by 2 and
     mrf.launches by 0; the waveform within 1e-3 * max of the CPU plain
     path;
  6b. generators off the hand kernels: HiFi-GAN V3 (ResBlock2, the
     public config_v3.json) and a ResBlock1 at V2's widths with dilations
     (1, 2, 4), seeded and made audible, on a 608-frame mel: cuDNN conv
     chains, no hand-kernel launch, within 1e-3 * max of the CPU, ms;
  7. training path: python -m radtts_tpu_torch.train_vocoder's main runs 5
     steps of HiFi-GAN v1 with the full discriminators at batch 16,
     segment 8192, on 4 seeded 2 s wavs, and checkpoints at the last step.
     Per-step ms and the five losses are printed; the losses must be
     finite, mel.launches must grow by 2, mrf.tc_launches by 72 and
     mrf.stack_launches and mrf.launches by 0 per step,
     and the checkpoints must reload. One more step runs under the
     profiler, and one step at batch 2 on the card is held against the
     same step on the CPU plain path from the same state (losses and
     updates) and its generator gradients against the step in float64;
  8. MAS kernels vs plain: ops/mas.py:mas against mas_plain on the card
     at (16, 512, 112), the flagship training batch, ragged (3, 997, 61),
     an item with in_len > out_len, (2, 2500, 100), (1, 7000, 200) and,
     past 256 tokens, ragged (2, 400, 300), (1, 2000, 600) and (1, 3000,
     1000) (16 and 32 tokens a lane): csrc/mas.cu's warp kernel (the route
     mas_route names, asserted) and the block kernel on the same inputs
     ("before"); then (1, 300, 1100), whose 1100 tokens take the block
     kernel (asserted): the hard alignments must be equal; the kernels'
     and the plain version's times and the bytes floor;
  9. RADTTS training path: python -m radtts_tpu_torch.train's main on a
     seeded dataset (16 training and 2 validation int16 wavs of 2-6 s,
     texts from filelists/), its caches first warmed by python -m
     radtts_tpu_torch.data -j 2 (the training runs must rewrite
     none of them): config_ljs_decoder.json at its published
     widths, 4 steps across both curriculum points with a validation and
     a checkpoint at steps 0 and 3, one step resumed from model_3,
     config_ljs_dap.json (use_amp=false) warm-started from it for 2 steps
     with the decoder frozen (every other parameter equal to the warm
     start's), and one text served from that checkpoint by
     python -m radtts_tpu_torch.inference's main. Losses must be finite;
     mas launches once per binarized step and validation batch, the MRF
     and mel kernels never (the serving after it is counted apart: 72
     mrf_tc launches per generator call); then
     config_ljs_bgap.json and config_ljs_agap.json as published
     (durf0energyvpred) warm-started from the decoder's model_3, 2 steps
     each, counted from 0 (mas 6: two binarized steps and one validation
     a run; ar_scan 0), and one text served from each checkpoint through
     the inference CLI (ar_scan 2 for AGAP, 0 for BGAP; mrf_tc 144);
     then voice conversion: python -m radtts_tpu_torch.
     inference_voice_conversion's main on the DAP checkpoint and the
     validation wavs, -n 2 at --sigma 0, injected features and
     --predict_features (mas 1 and mrf_tc 72 an utterance, 72 at load;
     wavs 22.05 kHz, finite, not silent), durations, mels and the first
     wav against the CPU (the CPU decodes from the card's durations), ms
     an utterance; then config_ljs_dap.json as published (use_amp true)
     for 2 steps and 2 more with bf16 optimizer moments (step ms, peak
     memory, the moments' bytes and dtypes; mas 3 a run); then (PR 11)
     the FFTransformer DAP config trained 2 steps (dropout on, mas 3),
     served from its checkpoint (mrf_tc 144) and stepped at batch 2
     against the CPU with dropout off; the plain-W config trained 2 steps
     from random weights, every module trainable (mas 3); and
     config_ljs_dap.json trained one step with its vocoder paths naming
     a seeded HiFi-GAN v1 and profile_dir set (the trace must hold CUDA
     kernels), then its checkpoint's validation with and without the
     audio samples (JAX's five tags at 22050 Hz, finite, not silent;
     mrf_tc 6 x 72, mas 1), timed; then (train_dp2_cli)
     python -m radtts_tpu_torch.train at WORLD_SIZE=2 on the decoder
     config, batch 8 a rank, 2 steps: rank 0 alone logs and writes
     model_0, which loads and steps in one process;
 10. RADTTS step time: the config_ljs_dap.json model, every module
     trainable, binarize and KL on, fp32, at bench_train.py's (16, 112,
     512): step ms (median of steps 2-5), mel frames/s, peak memory and a
     profiled step (device busy and idle share, top kernels), and
     one step's counted FLOP over the step time;
 10b. RADTTS steps on more than one rank (radtts_step_dp2, _tp2,
     _dp1_nccl): config_ljs_decoder.json at global (16, 112, 512),
     binarized, as 2 ranks of 8 ragged rows (gloo, the ranks' frame
     counts differ) and 2 ranks at n_model=2 (gloo) in one world, and 1
     rank on NCCL, each a process of this script (--step-rank) with the
     env contract, the kernels built before: each rank's first step
     within rtol 1e-3 (loss) and 2e-3 (grad norm) of the single-process
     step, mas_warp_kernel launched on every rank; step ms and the
     collectives' ms a step;
 11. RADTTS card against CPU: one step at batch 2 from the same state on
     the card, the CPU and the CPU in float64 (the CPU steps take the
     card's alignment, which must equal mas_plain's on the CPU's soft
     attention, or the near-tie is reported): losses within rtol 1e-3,
     gradients no further from float64 than max(1e-3, 2x the CPU's); the
     same for the BGAP and AGAP models with durf0energyvpred trainable;
 11b. SimpleConvNet and cuDNN: each distinct conv of the BGAP's
     SimpleConvNets forward and backward in fp32 on cuDNN (the port's
     layout and a contiguous one) and off it, against float64 (each
     within 1e-5 of max), with the kernels cuDNN ran and the times; the
     BGAP's serving attributes stage and training step with the
     SimpleConvNets on and off cuDNN; and the energy model's float64
     gradients under fp32-sized noise in those convs (the relu flips);
 11c. Griffin-Lim: ops/stft.py:griffin_lim (plain PyTorch; no path calls
     it) on (1, 608, 513) magnitudes, n_fft 1024, hop 256, 30 rounds,
     from one initial phase drawn on the CPU: the card's waveform within
     1e-2 * max of the CPU's (both runs' distances from a float64 run on
     the CPU logged); median ms of 10 synchronized runs, a profiled run;
     no hand-kernel launch;
 12. the {"kernels": [...]} line with the eleven kernels (mrf_tc,
     mrf_tf32, mrf_tc_one_pass, mrf_stack, mrf_conv, mel, mas and
     mas_block, ar_scan, lstm and ar_scan_barrier) and their launches by path (serve, serve_files,
     serve_v2, train, train_radtts, serve_bgap, serve_agap, train_gap,
     serve_gap_files, vc, serve_amp, train_amp, resblock2, serve_fft,
     train_fft, serve_fft_files, serve_plain_w, train_plain_w,
     serve_agap_bf16, train_audio_samples, serve_dp2, radtts_step_dp2,
     radtts_step_tp2, radtts_step_dp1_nccl, serve_high, serve_default);
     the ar_scan entry carries the
     chain floor and the split route's rows, the ar_scan_barrier entry its
     H = 1024 and 1022 timings; the mrf_tc and mrf_tf32 entries carry the
     padded widths' rows, the mrf_conv entry their before.
The last line is {"ok": true, "device": {...}}. Any failure raises, and the
exit code is not 0. Without CUDA, or without the rest of the repo beside
it, it exits 1 and prints no result. `--step-rank SPEC` runs one rank of
phase 10b (the script spawns it; run without arguments, it needs one
card).
"""

import base64
import copy
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "config_ljs_dap.json")
HIFIGAN_V1 = {
    "resblock": "1",
    "upsample_rates": [8, 8, 2, 2],
    "upsample_kernel_sizes": [16, 16, 4, 4],
    "upsample_initial_channel": 512,
    "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
}
# HiFi-GAN V2: jik876/hifi-gan config_v2.json, v1 with 128 initial channels
HIFIGAN_V2 = dict(HIFIGAN_V1, upsample_initial_channel=128)
MAX_FRAMES = 608            # 608 * 256 / 22050 Hz = 7.06 s of audio
STAGES = [(1, 4864, 256), (1, 38912, 128), (1, 77824, 64), (1, 155648, 32)]
TRAIN_STAGES = [(16, 256, 256), (16, 2048, 128),    # discriminator pass
                (16, 4096, 64), (16, 8192, 32)]
RAGGED = [(2, 997, 256), (2, 997, 128), (2, 997, 64), (2, 997, 32)]
# csrc/mrf_stack.cu's widths: HiFi-GAN V2's last two stages at 608 frames
STACK_STAGES = [(1, 77824, 16), (1, 155648, 8)]
STACK_RAGGED = [(2, 997, 16), (2, 997, 8), (2, 50, 16)]   # 50 < one tile
# the widths csrc/mrf.cu took before, now run padded on the tensor
# cores (ops/mrf.py:padded_width): 608 frames of stages at C=96, 48 and 24
# (the rates of v1 with 384 initial channels; no published generator has
# these stages) and one at C=160 (padded to 192), timed; a ragged C=40
PADDED_STAGES = [(1, 38912, 96), (1, 77824, 48), (1, 155648, 24),
                 (1, 38912, 160)]
PADDED_RAGGED = [(2, 997, 40)]
# a multiple of 64 that 128 does not divide: csrc/mrf_tf32.cu's tile 64
ODD_TC = [(2, 997, 192)]
# a C <= 16 stage with more resblocks than csrc/mrf_stack.cu takes: the
# narrow tensor-core kernel at 32
PADDED_RESBLOCKS = [((2, 997, 16), (3, 7, 11, 3, 7))]
MEL_SHAPES = [(16, 8192), (1, 155648), (3, 9001)]   # training, flagship
TRAIN_STEPS, TRAIN_BATCH, SEGMENT = 5, 16, 8192      # train_vocoder.py CLI
FP32_FLOPS = 67e12          # H100 SXM fp32 outside the tensor cores
TF32_FLOPS = 495e12         # H100 SXM dense TF32 on the tensor cores
HBM_BYTES = 3.35e12         # H100 SXM HBM3
TEXTS = [
    "It is well known that deep generative models have a rich latent "
    "space, and that it is possible to synthesize speech with "
    "controllable attributes.",
    "The quick brown fox jumps over the lazy dog.",
    "Printing, in the only sense with which we are at present concerned, "
    "differs from most if not from all the arts and crafts.",
]


_T0 = time.perf_counter()


def log(obj):
    """Print one line: a dict as JSON (a phase's with t_s, the seconds
    since the script started, so a run shows where its time went)."""
    if isinstance(obj, dict) and "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - _T0, 1)}
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def cuda_ms(fn, reps=10, warmup=2, min_ms=2.0):
    """Median milliseconds per call of fn() on the current stream: CUDA
    events around back-to-back calls lasting at least min_ms, so that the
    host's latency to launch one call is not counted as device time."""
    for _ in range(warmup):
        fn()
    _, one_ms = timed(fn)
    calls = max(1, math.ceil(min_ms / max(one_ms, 1e-3)))
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def timed(fn):
    torch.cuda.synchronize()
    tic = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - tic) * 1e3


def random_mrf_weights(C, dev, gen, ks=(3, 7, 11)):
    def rnd(*shape):
        return 0.01 * torch.randn(*shape, device=dev, generator=gen)
    return [{"w1": rnd(3, k, C, C), "b1": rnd(3, C),
             "w2": rnd(3, k, C, C), "b2": rnd(3, C)} for k in ks]


def library_mrf(xc, torch_weights):
    """The same MRF as a chain of cuDNN F.conv1d calls on channels-first
    input (B, C, T), conv weights pre-laid out as (C_out, C_in, K)."""
    out = torch.zeros_like(xc)
    for w1, b1, w2, b2 in torch_weights:
        xr = xc
        for i, d in enumerate((1, 3, 5)):
            k = w1[i].shape[-1]
            xt = F.conv1d(F.leaky_relu(xr, 0.1), w1[i], b1[i],
                          padding=(k - 1) // 2 * d, dilation=d)
            xt = F.conv1d(F.leaky_relu(xt, 0.1), w2[i], b2[i],
                          padding=(k - 1) // 2)
            xr = xr + xt
        out = out + xr
    return out / len(torch_weights)


def library_inputs(x, weights):
    """library_mrf's inputs: x channels-first, the taps as (C_out, C_in,
    K)."""
    return x.transpose(1, 2).contiguous(), [
        tuple(t.permute(0, 3, 2, 1).contiguous() if t.dim() == 4 else t
              for t in (wd["w1"], wd["b1"], wd["w2"], wd["b2"]))
        for wd in weights]


def tc_tiles(C):
    """The tensor-core kernel's tile shapes (TN, NWG) at width C: TN = C
    at C=64 and C=32 (one or two warpgroups) and C=96 (one), four at the
    wider stages."""
    if C == 96:
        return [(96, 1)]
    if C <= 64:
        return [(C, 1), (C, 2)]
    return [(64, 1), (64, 2), (128, 1), (128, 2)]


STACK_TILES = [200, 295, 352, 394, 400, 512]   # stack kernel tile rows
CHAIN_PASSES = 49   # (B, T, C) passes of the 18-launch chain, see below


def mrf_bound(B, T, C, ks=(3, 7, 11)):
    """The least time of one MRF stage: its FLOP, fp32-accurate, at the
    3xTF32 rate (3 tensor-core passes, 495/3 TFLOP/s), against x and the
    weights read once and the output written once. Also returns the FLOP,
    the operations' time at the 67 TFLOP/s fp32-FMA rate, and the chain's
    activation-bytes floor: the 18 launches as ops/mrf.py:mrf chains them
    move CHAIN_PASSES whole (B, T, C) tensors through memory (per resblock
    16: 2 per first conv, 3 per second conv, 4 for the last, which
    accumulates the mean; and the mean's zero fill), none of them kept in
    L2, over the HBM rate."""
    flop = 2.0 * B * T * C * C * sum(6 * k for k in ks)
    n_weights = sum(6 * (k * C * C + C) for k in ks)
    nbytes = 4.0 * (2 * B * T * C + n_weights)
    t_ops, t_bytes = 3 * flop / TF32_FLOPS, nbytes / HBM_BYTES
    chain_bytes = 4.0 * (CHAIN_PASSES * B * T * C + n_weights)
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flop,
            max(flop / FP32_FLOPS, t_bytes) * 1e3,
            chain_bytes / HBM_BYTES * 1e3)


KERNEL_OF_ROUTE = {"tc": "mrf_tc", "tf32": "mrf_tf32", "stack": "mrf_stack",
                   "conv": "mrf_conv"}


def v1_launches(mrf_mod, passes):
    """{kernel: launches} of one HiFi-GAN v1 generator call at `passes`
    TF32 passes: 18 a stage on the kernel mrf_route names (route "tc" at
    one pass is csrc/mrf_tc.cu's one-pass build, mrf_tc_one_pass)."""
    want = {}
    for C in (256, 128, 64, 32):
        route = mrf_mod.mrf_route(C, 3, passes)
        name = ("mrf_tc_one_pass" if (route, passes) == ("tc", 1)
                else KERNEL_OF_ROUTE[route])
        want[name] = want.get(name, 0) + 18
    return want


def phase_kernels(mrf_mod, dev):
    gen = torch.Generator(dev).manual_seed(1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stages = []
    max_err = {"mrf_tc": 0.0, "mrf_stack": 0.0, "mrf_conv": 0.0}
    inputs = {}
    timed_shapes = STAGES + TRAIN_STAGES + STACK_STAGES
    cases = [(shape, (3, 7, 11)) for shape in (
        STAGES + TRAIN_STAGES + RAGGED + ODD_TC + STACK_STAGES
        + STACK_RAGGED)]
    for (B, T, C), ks in cases:
        x = torch.randn(B, T, C, device=dev, generator=gen)
        w = random_mrf_weights(C, dev, gen, ks)
        kernel = KERNEL_OF_ROUTE[mrf_mod.mrf_route(C, len(ks))]
        got = mrf_mod.mrf(x, w)
        ref = mrf_mod.mrf_plain(x, w)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        max_err[kernel] = max(max_err[kernel], err)
        if not err <= 1e-4 * scale:
            raise AssertionError(f"{kernel} disagrees at {(B, T, C)}: "
                                 f"max|k-p| {err} > 1e-4 * {scale}")
        row = {"phase": "kernel_vs_plain", "kernel": kernel,
               "shape": [B, T, C], "resblocks": len(ks), "max_abs_err": err,
               "max_abs_plain": scale}
        if kernel == "mrf_tc":
            row["grid"] = list(mrf_mod.tc_grid(B, T, C))
            row["tile"] = list(mrf_mod.tc_tile(C))
        elif kernel == "mrf_stack":
            tile = mrf_mod.stack_tile(T, B, sms)
            row["tile_rows"] = tile
            row["grid"] = [-(-T // tile), B]
        if C <= 64 and kernel != "mrf_conv":
            # the kernel these stages ran before, on the same inputs
            conv = mrf_mod.mrf_cuda(x, w, route="conv")
            row["conv_route_max_abs_err"] = (conv - ref).abs().max().item()
            max_err["mrf_conv"] = max(max_err["mrf_conv"],
                                      row["conv_route_max_abs_err"])
            if not row["conv_route_max_abs_err"] <= 1e-4 * scale:
                raise AssertionError(f"mrf_conv disagrees at {(B, T, C)}")
        if (B, T, C) in timed_shapes:
            xc, tw = library_inputs(x, w)
            bound_ms, bound_by, flop, fp32_bound_ms, chain_ms = mrf_bound(
                B, T, C)
            row.update(
                ms=cuda_ms(lambda: mrf_mod.mrf(x, w)),
                plain_ms=cuda_ms(lambda: mrf_mod.mrf_plain(x, w)),
                library_ms=cuda_ms(lambda: library_mrf(xc, tw)),
                bound_ms=bound_ms, bound_by=bound_by,
                fp32_fma_bound_ms=fp32_bound_ms,
                chain_bytes_floor_ms=chain_ms, gflop=flop / 1e9)
            if "conv_route_max_abs_err" in row:
                row["conv_route_ms"] = cuda_ms(
                    lambda: mrf_mod.mrf_cuda(x, w, route="conv"))
            row["tflops"] = flop / row["ms"] / 1e9
            row["serving"] = (B, T, C) in STAGES + STACK_STAGES
            stages.append(row)
            inputs[(B, T, C)] = (x, w)
        log(row)
    return stages, max_err, inputs


def phase_tiles(mrf_mod, inputs):
    """The tensor-core kernel's tile shapes (TN, NWG) at the v1 serving
    stages and the stack kernel's tile rows at the V2 ones, each held to
    the same limit as the chosen one."""
    sweeps = [(shape, "tc", tc_tiles(shape[2])) for shape in STAGES]
    sweeps += [(shape, "stack", STACK_TILES) for shape in STACK_STAGES]
    for (B, T, C), route, tiles in sweeps:
        x, w = inputs[(B, T, C)]
        ref = mrf_mod.mrf_plain(x, w)
        scale = ref.abs().max().item()
        chosen = (mrf_mod.tc_tile(C) if route == "tc" else mrf_mod.stack_tile(
            T, B, torch.cuda.get_device_properties(x.device)
            .multi_processor_count))
        for tile in tiles:
            err = (mrf_mod.mrf_cuda(x, w, tile, route) - ref).abs().max(
                ).item()
            if not err <= 1e-4 * scale:
                raise AssertionError(f"{route} tile {tile} disagrees at "
                                     f"{(B, T, C)}: {err} > 1e-4 * {scale}")
            row = {"phase": f"mrf_{route}_tiles", "shape": [B, T, C],
                   "tile": tile, "chosen": tile == chosen,
                   "max_abs_err": err,
                   "ms": cuda_ms(lambda: mrf_mod.mrf_cuda(x, w, tile, route))}
            if route == "tc":
                row["grid"] = list(mrf_mod.tc_grid(B, T, C, tile))
            log(row)


def mel_bound(B, n, fb_nnz, n_fft=1024, hop=256, n_mels=80):
    """The least work of the log-mel of (B, n) audio, per frame: a real FFT
    (2.5 n_fft log2 n_fft FLOP), the magnitude of n_fft/2+1 bins (4 FLOP
    each, the square root counted as one), 2 FLOP for each of the
    filterbank's fb_nnz nonzeros and one log per mel, over the fp32 rate;
    against the audio, the window and the filterbank's nonzeros read once
    and the log-mel written once, over the HBM rate. Also returns the
    kernel's own FLOP (csrc/mel.cu): n_fft window products, the Stockham
    stages of the n_fft/2-point complex FFT (34 per radix-4 butterfly, 10
    per radix-2), 16 per unpacked bin, the magnitudes, the sparse mel sums
    and the logs."""
    from radtts_tpu_torch.ops.mel import fft_radices

    frames = B * (1 + n // hop)
    n_freq = n_fft // 2 + 1
    flop = frames * (2.5 * n_fft * math.log2(n_fft) + 4.0 * n_freq
                     + 2.0 * fb_nnz + n_mels)
    nbytes = 4.0 * (B * n + n_fft + fb_nnz + frames * n_mels)
    t_ops, t_bytes = flop / FP32_FLOPS, nbytes / HBM_BYTES
    m = n_fft // 2
    fft_flop = sum((m // r) * (34 if r == 4 else 10) for r in fft_radices(m))
    design_flop = frames * (n_fft + fft_flop + 16.0 * (m - 1) + 4.0 * n_freq
                            + 2.0 * fb_nnz + n_mels)
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", design_flop)


def composite_mel(a, window, fb):
    """The cuFFT composite: torch.stft + mel matmul (dense) + log(clamp),
    three or more launches; timed for information."""
    spec = torch.stft(a, 1024, 256, 1024, window=window, center=True,
                      pad_mode="reflect", return_complex=True).abs()
    return torch.log(torch.clamp(fb @ spec, min=1e-5)).transpose(1, 2)


def phase_mel_kernels(mel_mod, dev, mel_kw):
    from radtts_tpu_torch.ops.stft import mel_basis

    fb = torch.from_numpy(mel_basis(22050, 1024, 80, 0.0, 8000.0)).to(dev)
    window = torch.hann_window(1024, periodic=True, device=dev)
    gen = torch.Generator(dev).manual_seed(2)
    rows, max_err = [], 0.0
    for B, n in MEL_SHAPES:
        a = torch.rand(B, n, device=dev, generator=gen) * 1.6 - 0.8
        got = mel_mod.mel(a, **mel_kw)
        ref = mel_mod.mel_plain(a, **mel_kw)
        err = (got - ref).abs().max().item()
        max_err = max(max_err, err)
        if got.shape != ref.shape or not err <= 1e-3:
            raise AssertionError(f"mel kernel disagrees at {(B, n)}: "
                                 f"{tuple(got.shape)}, max|k-p| {err}")
        cot = torch.randn(ref.shape, device=dev, generator=gen)
        grads = []
        for fn in (mel_mod.mel, mel_mod.mel_plain):
            x = a.clone().requires_grad_(True)
            (fn(x, **mel_kw) * cot).sum().backward()
            grads.append(x.grad)
        g_err = (grads[0] - grads[1]).abs().max().item()
        g_max = grads[1].abs().max().item()
        if not g_err <= 1e-5 * g_max:
            raise AssertionError(f"mel gradient disagrees at {(B, n)}: "
                                 f"{g_err} > 1e-5 * {g_max}")
        bound_ms, bound_by, design_flop = mel_bound(
            B, n, int(torch.count_nonzero(fb)))
        row = {"phase": "mel_kernel_vs_plain", "shape": [B, n],
               "max_abs_err": err, "max_abs_plain": ref.abs().max().item(),
               "grad_max_abs_err": g_err, "grad_max_abs_plain": g_max,
               "ms": cuda_ms(lambda: mel_mod.mel(a, **mel_kw)),
               "plain_ms": cuda_ms(lambda: mel_mod.mel_plain(a, **mel_kw)),
               "composite_ms": cuda_ms(lambda: composite_mel(a, window, fb)),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "design_gflop": design_flop / 1e9}
        row["design_tflops"] = design_flop / row["ms"] / 1e9
        rows.append(row)
        log(row)
    return rows, max_err


def phase_guard(mrf_mod, dev):
    """The MRF kernel has no backward: asked for an output that would need
    a gradient, it must raise and launch nothing."""
    gen = torch.Generator(dev).manual_seed(4)
    w = random_mrf_weights(32, dev, gen)
    w[0]["w1"].requires_grad_(True)
    x = torch.randn(1, 256, 32, device=dev, generator=gen)
    before = (mrf_mod.mrf.launches, mrf_mod.mrf.tc_launches)
    try:
        mrf_mod.mrf(x, w)
    except RuntimeError as e:
        if (mrf_mod.mrf.launches, mrf_mod.mrf.tc_launches) != before:
            raise AssertionError("mrf launched before refusing") from e
        log({"phase": "mrf_grad_guard", "raised": str(e)})
        return
    raise AssertionError("mrf ran the kernel with grad-requiring weights")


def flagship_parts(dev):
    from radtts_tpu_torch.models.hifigan import Generator, denoiser_init
    from radtts_tpu_torch.models.radtts import RADTTS

    with open(CONFIG) as f:
        config = json.load(f)
    model_config = config["model_config"]
    torch.manual_seed(0)
    model = RADTTS(model_config).eval().requires_grad_(False)
    # the WN end convs are zero-initialised, which makes decode vacuous
    for flow in model.flows:
        torch.nn.init.normal_(flow.affine.pred.end.weight, std=0.002)
    vocoder = Generator(HIFIGAN_V1).to(dev).eval().requires_grad_(False)
    denoiser = denoiser_init(vocoder)
    return config, model, vocoder, denoiser


def flagship_input(synth):
    """TEXTS[0] with fixed durations summing to MAX_FRAMES (CPU tensors)."""
    text = torch.as_tensor(synth.encode(TEXTS[0]))[None]
    N = text.shape[1]
    dur = torch.full((1, N), MAX_FRAMES // N, dtype=torch.int32)
    dur[0, -1] += MAX_FRAMES - int(dur.sum())
    return text, dur


def phase_reference(synth, dev):
    """Decode and vocoder on the card vs the CPU plain path, on the
    608-frame flagship utterance with a seeded decoder residual."""
    from radtts_tpu_torch.models.radtts import radtts_infer

    text, dur = flagship_input(synth)
    meta = synth.model.meta
    g = meta["n_group_size"]
    gen = torch.Generator().manual_seed(3)
    res = torch.randn(1, MAX_FRAMES // g, meta["n_mel_channels"] * g,
                      generator=gen) * 0.8
    spk = torch.zeros(1, dtype=torch.int64)
    mel_gpu = radtts_infer(synth.model, spk.to(dev), text.to(dev), 0.8,
                           MAX_FRAMES, dur=dur.to(dev),
                           residual=res.to(dev))["mel"]
    wav_gpu = synth.vocoder(mel_gpu)
    model_cpu = synth.model.to("cpu")
    mel_cpu = radtts_infer(model_cpu, spk, text, 0.8, MAX_FRAMES, dur=dur,
                           residual=res)["mel"]
    synth.model.to(dev)
    wav_cpu = synth.vocoder.to("cpu")(mel_gpu.cpu())
    synth.vocoder.to(dev)
    mel_err = (mel_gpu.cpu() - mel_cpu).abs().max().item()
    wav_err = (wav_gpu.cpu() - wav_cpu).abs().max().item()
    wav_scale = wav_cpu.abs().max().item()
    if mel_gpu.shape != (1, MAX_FRAMES, meta["n_mel_channels"]) or \
            wav_gpu.shape != (1, MAX_FRAMES * synth.hop_length):
        raise AssertionError(f"shapes {tuple(mel_gpu.shape)}, "
                             f"{tuple(wav_gpu.shape)}")
    log({"phase": "gpu_vs_cpu", "frames": MAX_FRAMES,
         "mel_max_abs_err": mel_err,
         "mel_max_abs": mel_cpu.abs().max().item(),
         "wav_max_abs_err": wav_err, "wav_max_abs": wav_scale})
    # decode: the CPU parity bound of the port's tests; vocoder: the
    # kernel's 1e-4 * max bound, loosened 10x for the 4 chained stages
    if not mel_err <= 1e-3:
        raise AssertionError(f"decode on the card vs CPU: {mel_err}")
    if not wav_err <= 1e-3 * wav_scale:
        raise AssertionError(f"vocoder on the card vs CPU: {wav_err}")


def phase_main_path(synth, mrf_mod, dev, power):
    from radtts_tpu_torch.models.hifigan import denoiser_apply
    from radtts_tpu_torch.models.radtts import infer_durations, radtts_infer

    from radtts_tpu_torch.ops.lstm import lstm_cuda

    hop = synth.hop_length
    n_generator_calls = 0
    _reset_mrf(mrf_mod)
    lstm_cuda.launches = 0
    requests = [(TEXTS[0], {}), (TEXTS, {}),
                (TEXTS[1], {"denoising_strength": 0.1, "sigma": 0.6})]
    for texts, kw in requests:
        (wavs, aux), ms = timed(lambda: synth.synthesize(texts, "ljs", **kw))
        n_generator_calls += 1
        for wav, n in zip(wavs, aux["n_frames"]):
            if wav.shape != (int(n) * hop,) or not torch.isfinite(
                    torch.as_tensor(wav)).all():
                raise AssertionError(f"bad output: {wav.shape}, {n} frames")
        log({"phase": "request", "n_texts": len(wavs),
             "n_frames": [int(n) for n in aux["n_frames"]], "ms": ms, **kw})

    # fixed-duration flagship utterance (608 frames)
    with torch.inference_mode():
        text, dur = (t.to(dev) for t in flagship_input(synth))
        spk = torch.zeros(1, dtype=torch.int64, device=dev)

        def utterance():
            _, t_dur = timed(lambda: infer_durations(synth.model, spk, text))
            out, t_dec = timed(lambda: radtts_infer(
                synth.model, spk, text, 0.8, MAX_FRAMES, dur=dur,
                generator=synth.generator))
            audio, t_voc = timed(lambda: denoiser_apply(
                synth.denoiser, synth.vocoder(out["mel"]), strength=0.01))
            return audio, {"durations": t_dur, "decode": t_dec,
                           "vocoder_denoiser": t_voc}

        runs = [utterance() for _ in range(3)]
        audio = runs[-1][0]
        times = {k: [t[k] for _, t in runs] for k in runs[0][1]}
        profile = profile_run(utterance)
        n_generator_calls += len(runs) + 1
    launches = dict(_mrf_counts(mrf_mod), lstm=lstm_cuda.launches)
    if audio.shape != (1, MAX_FRAMES * hop) or not torch.isfinite(
            audio).all():
        raise AssertionError(f"bad flagship audio {tuple(audio.shape)}")
    if launches != {"mrf_conv": 0, "mrf_tc": 72 * n_generator_calls,
                    "mrf_tc_one_pass": 0, "mrf_tf32": 0,
                    "mrf_stack": 0,
                    "lstm": DAP_CALL_LSTMS * n_generator_calls}:
        raise AssertionError(f"launches {launches} != 72 tc x "
                             f"{n_generator_calls} generator calls")
    med = {k: statistics.median(v) for k, v in times.items()}
    audio_s = MAX_FRAMES * hop / synth.sampling_rate
    log({"phase": "flagship_608", "card": power, "stage_ms": med,
         "stage_ms_all": times, "audio_s": audio_s,
         "rtf": sum(med.values()) / 1e3 / audio_s,
         "mrf_launches": launches, "generator_calls": n_generator_calls})
    log({"phase": "profile_608", **profile})
    return launches


LONG_TEXT = ("Printing, in the only sense with which we are at present "
             "concerned, differs from most if not from all the arts and "
             "crafts represented in the Exhibition. It is well known that "
             "deep generative models have a rich latent space; it is "
             "possible to synthesize speech with controllable attributes.")
FILES_CHUNK = 40          # --long_text_chunk of the serving-from-files phase
FILES_BATCH = 4           # --batch_size of its inference CLI run


def _http(base, path, body=None, timeout=120):
    """GET (body None) or POST JSON; (status, content type, bytes)."""
    import urllib.request

    req = urllib.request.Request(
        base + path, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _check_wav(data, what):
    """A 22.05 kHz float32 WAV (bytes or path) that is finite and not
    silent; returns its samples."""
    import io

    from scipy.io import wavfile

    sr, audio = wavfile.read(io.BytesIO(data) if isinstance(data, bytes)
                             else data)
    if sr != 22050 or audio.dtype != np.float32 or audio.ndim != 1 or \
            not np.isfinite(audio).all() or not np.abs(audio).max() > 1e-3:
        raise AssertionError(f"bad wav {what}: sr {sr}, {audio.dtype}, "
                             f"{audio.shape}, max {np.abs(audio).max()}")
    return audio


def phase_serve_files(synth, mrf_mod, dev, power):
    """Serving from checkpoint files, at the flagship width: the in-memory
    model and vocoder written by the port's writers, then read by the
    inference CLI (python -m radtts_tpu_torch.inference) and by the daemon
    (radtts_tpu_torch.serve.build_server, in a thread on a free port),
    counts set to 0 just before the CLI and read just after the daemon's
    last request. The file-loaded model is then held against the
    in-memory one on the 608-frame utterance."""
    import threading

    from radtts_tpu_torch.export import export_torch_checkpoint
    from radtts_tpu_torch.inference import main as inference_main
    from radtts_tpu_torch.models.hifigan import generator_to_reference
    from radtts_tpu_torch.models.radtts import radtts_infer
    from radtts_tpu_torch.ops.lstm import lstm_cuda
    from radtts_tpu_torch.serve import build_server
    from radtts_tpu_torch.text.chunking import split_text_to_chunks

    lines = TEXTS + [LONG_TEXT]

    def n_chunks(text):
        return len(split_text_to_chunks(
            text, lambda t: len(synth.encode(t)), FILES_CHUNK))

    with tempfile.TemporaryDirectory() as root:
        paths = {k: os.path.join(root, name) for k, name in (
            ("radtts", "radtts.pt"), ("vocoder", "hifigan.pt"),
            ("vocoder_config", "hifigan.json"), ("text", "lines.txt"),
            ("out", "out"))}
        tic = time.perf_counter()
        export_torch_checkpoint(paths["radtts"], synth.model)
        t_radtts = time.perf_counter() - tic
        torch.save({"generator": generator_to_reference(synth.vocoder)},
                   paths["vocoder"])
        with open(paths["vocoder_config"], "w") as f:
            json.dump(HIFIGAN_V1, f)
        with open(paths["text"], "w") as f:
            f.write("\n".join(lines) + "\n")
        files = ["-c", CONFIG, "-r", paths["radtts"], "-v", paths["vocoder"],
                 "-k", paths["vocoder_config"], "-s", "ljs", "--seed", "0"]

        _reset_mrf(mrf_mod)
        lstm_cuda.launches = 0
        tic = time.perf_counter()
        written = inference_main(files + [
            "-t", paths["text"], "-o", paths["out"], "--batch_size",
            str(FILES_BATCH), "--long_text_chunk", str(FILES_CHUNK)])
        cli_s = time.perf_counter() - tic
        n_items = sum(n_chunks(t) for t in lines)
        # the denoiser's bias call at load, then one call per batch
        generator_calls = 1 + -(-n_items // FILES_BATCH)
        if len(written) != len(lines) or n_items <= len(lines):
            raise AssertionError(f"CLI wrote {len(written)} wavs from "
                                 f"{n_items} chunks of {len(lines)} lines")
        for path in written:
            _check_wav(path, path)

        server, file_synth, state = build_server(
            files + ["--port", "0", "--batch_wait_ms", "5"])
        generator_calls += 1                    # the denoiser's bias call
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = "http://%s:%d" % server.server_address[:2]
        try:
            health = json.loads(_http(base, "/healthz")[2])
            if not health["ok"]:
                raise AssertionError(f"/healthz {health}")
            latency_ms = []
            for _ in range(2):      # the first request, then a warm one
                tic = time.perf_counter()
                _, ctype, body = _http(base, "/tts", {"text": TEXTS[1]})
                latency_ms.append((time.perf_counter() - tic) * 1e3)
                if ctype != "audio/wav":
                    raise AssertionError(f"/tts answered {ctype}")
                _check_wav(body, "/tts single")
            _, _, body = _http(base, "/tts", {"texts": TEXTS})
            batch = json.loads(body)
            if len(batch["wavs"]) != len(TEXTS):
                raise AssertionError(f"/tts texts: {len(batch['wavs'])}")
            for b64 in batch["wavs"]:
                _check_wav(base64.b64decode(b64), "/tts texts")
            tic = time.perf_counter()
            _, _, body = _http(base, "/tts", {
                "text": LONG_TEXT, "stream": True,
                "long_text_chunk": FILES_CHUNK})
            stream_ms = (time.perf_counter() - tic) * 1e3
            pcm = np.frombuffer(body[44:], "<f4")
            if len(body) <= 44 or not np.isfinite(pcm).all() or \
                    not np.abs(pcm).max() > 1e-3:
                raise AssertionError(f"stream: {len(body)} bytes")
            parts = n_chunks(LONG_TEXT)
            generator_calls += 2 + 1 + 1 + (parts > 1)
            before = json.loads(_http(base, "/healthz")[2])

            def single(i, out, barrier):
                barrier.wait(timeout=60)
                out[i] = _http(base, "/tts", {"text": TEXTS[i]})[2]

            out, barrier = [None] * len(TEXTS), threading.Barrier(len(TEXTS))
            threads = [threading.Thread(target=single,
                                        args=(i, out, barrier))
                       for i in range(len(TEXTS))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            if any(t.is_alive() for t in threads) or None in out:
                raise AssertionError("a concurrent request did not finish")
            for body in out:
                _check_wav(body, "/tts concurrent")
            after = json.loads(_http(base, "/healthz")[2])
            dispatches = (after["batched_dispatches"]
                          - before["batched_dispatches"])
            generator_calls += dispatches
            if not 1 <= dispatches < len(TEXTS):
                raise AssertionError(f"{len(TEXTS)} concurrent singles took "
                                     f"{dispatches} dispatches")
            launches = dict(_mrf_counts(mrf_mod), lstm=lstm_cuda.launches)
            # the two denoiser bias calls run no model
            if launches != {"mrf_conv": 0, "mrf_tc": 72 * generator_calls,
                            "mrf_tc_one_pass": 0, "mrf_tf32": 0,
                            "mrf_stack": 0,
                            "lstm": DAP_CALL_LSTMS * (generator_calls - 2)}:
                raise AssertionError(f"launches {launches} != 72 tc x "
                                     f"{generator_calls} generator calls")
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=60)

    # the file-loaded model and vocoder against the in-memory ones
    with torch.inference_mode():
        text, dur = (t.to(dev) for t in flagship_input(synth))
        meta = synth.model.meta
        g = meta["n_group_size"]
        res = torch.randn(1, MAX_FRAMES // g, meta["n_mel_channels"] * g,
                          generator=torch.Generator().manual_seed(3)) * 0.8
        spk = torch.zeros(1, dtype=torch.int64, device=dev)
        mels, wavs = [], []
        for s in (synth, file_synth):
            mels.append(radtts_infer(s.model, spk, text, 0.8, MAX_FRAMES,
                                     dur=dur, residual=res.to(dev))["mel"])
            wavs.append(s.vocoder(mels[-1]))
    errs = {k: ((a - b).abs().max().item(), b.abs().max().item())
            for k, (a, b) in (("mel", mels), ("wav", wavs))}
    log({"phase": "serve_files", "card": power,
         "checkpoint_write_s": t_radtts,
         "load_phases_s": file_synth.load_phases,
         "cli_s": cli_s, "cli_wavs": len(written), "cli_chunks": n_items,
         "first_request_ms": latency_ms[0], "warm_request_ms": latency_ms[1],
         "stream_ms": stream_ms, "stream_chunks": parts,
         "concurrent_singles": len(TEXTS), "batched_dispatches": dispatches,
         "generator_calls": generator_calls, "mrf_launches": launches,
         "requests": state["requests"],
         "file_vs_memory": {k: {"max_abs_err": e, "max_abs": m}
                            for k, (e, m) in errs.items()}})
    for k, (e, m) in errs.items():
        if not e <= 1e-4 * m:
            raise AssertionError(f"file-loaded {k} vs in-memory: {e} > "
                                 f"1e-4 * {m}")
    return launches


PORT_KERNELS = ("mrf_conv_kernel", "mrf_tc_kernel", "mrf_tc_narrow_kernel",
                "mrf_stack_kernel", "mel_fft_kernel", "mas_kernel")


def phase_serve_v2(mrf_mod, dev, power):
    """HiFi-GAN V2 serving: the generator of config_v2.json (random
    weights, seed 5) on a seeded 608-frame log-mel, counts set to 0 just
    before and read just after; the waveform against the CPU plain path."""
    from radtts_tpu_torch.models.hifigan import Generator

    torch.manual_seed(5)
    vocoder = Generator(HIFIGAN_V2).eval().requires_grad_(False)
    gen = torch.Generator().manual_seed(6)
    mel = 2.0 * torch.randn(1, MAX_FRAMES, 80, generator=gen) - 5.0
    with torch.inference_mode():
        wav_cpu = vocoder(mel)
        vocoder.to(dev)
        mel_dev = mel.to(dev)
        _reset_mrf(mrf_mod)
        runs = [timed(lambda: vocoder(mel_dev)) for _ in range(4)]
        profile = profile_run(lambda: timed(lambda: vocoder(mel_dev)))
        n_calls = len(runs) + 1
    launches = _mrf_counts(mrf_mod)
    wav = runs[-1][0]
    if wav.shape != (1, MAX_FRAMES * 256) or not torch.isfinite(wav).all():
        raise AssertionError(f"bad V2 audio {tuple(wav.shape)}")
    if launches != {"mrf_conv": 0, "mrf_tc": 36 * n_calls,
                    "mrf_tc_one_pass": 0, "mrf_tf32": 0,
                    "mrf_stack": 2 * n_calls}:
        raise AssertionError(f"V2 MRF launches {launches} != 36 tc + 2 "
                             f"stack x {n_calls} generator calls")
    err = (wav.cpu() - wav_cpu).abs().max().item()
    scale = wav_cpu.abs().max().item()
    ms = [t for _, t in runs[1:]]     # the first call is the warm-up
    log({"phase": "serve_v2_608", "card": power, "vocoder_ms": ms,
         "vocoder_ms_median": statistics.median(ms),
         "wav_max_abs_err": err, "wav_max_abs": scale,
         "mrf_launches": launches, "generator_calls": n_calls})
    log({"phase": "profile_v2_608", **profile})
    if not err <= 1e-3 * scale:
        raise AssertionError(f"V2 vocoder on the card vs CPU: {err}")
    return launches, statistics.median(ms)


def profile_run(fn, top=12):
    """fn() (which ends by waiting for the card) under torch.profiler:
    device time by kernel and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tic = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - tic) * 1e3

    def on_device(e):
        # user annotations (e.g. Optimizer.step) span kernels on the device
        # timeline; counting them would count those kernels twice
        return (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False))

    kernels = [(e.key, e.count, e.self_device_time_total / 1e3)
               for e in prof.key_averages() if on_device(e)]
    kernels.sort(key=lambda k: -k[2])
    # busy time: the union of the device events' intervals. On one stream
    # the intervals cannot overlap, so their plain sum (event_sum_ms) must
    # equal the union; where it is larger, either the kernels ran on more
    # than one stream (`streams`) or the trace's times are off
    device_events = [e for e in prof.events() if on_device(e)]
    intervals = [(e.time_range.start, e.time_range.end)
                 for e in device_events]
    busy_us, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    busy_ms = busy_us / 1e3 if kernels else None
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_kernel_sum_ms": sum(k[2] for k in kernels),
            "event_sum_ms": sum(b - a for a, b in intervals) / 1e3,
            "n_events": len(intervals),
            "n_distinct_intervals": len(set(intervals)),
            # the trace's stream (resource) ids of the device events
            "streams": sorted({str(getattr(e, "device_resource_id", None))
                               for e in device_events}),
            "port_kernels": [{"name": n[:60], "count": c, "ms": ms}
                             for n, c, ms in kernels
                             if any(name in n for name in PORT_KERNELS)],
            "device_idle_share": (None if busy_ms is None
                                  else 1.0 - busy_ms / wall_ms),
            "top_kernels": [{"name": n[:90], "count": c, "ms": ms}
                            for n, c, ms in kernels[:top]]}


def write_dataset(root, data_config):
    """4 seeded 2 s int16 wavs (two sines plus noise), their filelist, the
    flagship config repointed at them and HIFIGAN_V1, under root.
    Returns (config path, HiFi-GAN config path)."""
    from scipy.io import wavfile

    sr = data_config["sampling_rate"]
    os.makedirs(os.path.join(root, "wavs"))
    rng = np.random.default_rng(0)
    t = np.arange(2 * sr) / sr
    names = []
    for i in range(4):
        hz = 110.0 * (i + 2)
        w = (0.3 * np.sin(2 * np.pi * hz * t)
             + 0.2 * np.sin(2 * np.pi * 2.5 * hz * t)
             + 0.05 * rng.standard_normal(t.size))
        wavfile.write(os.path.join(root, "wavs", f"{i}.wav"), sr,
                      (w * 32767).astype(np.int16))
        names.append(f"{i}.wav|text|ljs\n")
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.writelines(names)
    with open(CONFIG) as f:
        config = json.load(f)
    config["data_config"]["training_files"] = {
        "T": {"basedir": root, "audiodir": "wavs", "filelist": "train.txt"}}
    paths = (os.path.join(root, "config.json"),
             os.path.join(root, "hifigan.json"))
    for path, obj in zip(paths, (config, HIFIGAN_V1)):
        with open(path, "w") as f:
            json.dump(obj, f)
    return paths


def phase_training(mel_mod, mrf_mod, dev, data_config):
    """The training path through its CLI entry point, counts set to 0 just
    before and read just after."""
    from radtts_tpu_torch.models.hifigan import generator_from_reference
    from radtts_tpu_torch.train.vocoder_trainer import vocoder_train_init
    from radtts_tpu_torch.train_vocoder import main as train_main

    with tempfile.TemporaryDirectory() as root:
        config_path, hifigan_path = write_dataset(root, data_config)
        out = os.path.join(root, "out")
        torch.cuda.reset_peak_memory_stats()
        mel_mod.mel.launches = 0
        _reset_mrf(mrf_mod)
        history = train_main([
            "-c", config_path, "-k", hifigan_path, "-o", out,
            "--steps", str(TRAIN_STEPS), "--batch_size", str(TRAIN_BATCH),
            "--segment_size", str(SEGMENT), "--log_interval", "1",
            "--seed", "0"])
        launches = {"mel": mel_mod.mel.launches, **_mrf_counts(mrf_mod)}
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        for h in history:
            if not all(np.isfinite(v) for v in h.values()):
                raise AssertionError(f"non-finite training step {h}")
        if len(history) != TRAIN_STEPS or launches != {
                "mel": 2 * TRAIN_STEPS, "mrf_conv": 0,
                "mrf_tc": 72 * TRAIN_STEPS, "mrf_tc_one_pass": 0,
                "mrf_tf32": 0,
                "mrf_stack": 0}:
            raise AssertionError(f"{len(history)} steps, launches {launches}")
        tag = f"{TRAIN_STEPS:08d}"
        generator_from_reference(torch.load(os.path.join(
            out, f"g_{tag}.pt"))["generator"], HIFIGAN_V1)
        state = torch.load(os.path.join(out, f"do_{tag}.pt"),
                           map_location=dev)
        vocoder_train_init(HIFIGAN_V1).to(dev).load_state_dict(
            state["models"])
        if state["iteration"] != TRAIN_STEPS:
            raise AssertionError(f"checkpoint iteration {state['iteration']}")
    log({"phase": "train_vocoder", "batch": TRAIN_BATCH, "segment": SEGMENT,
         "steps": history, "steady_step_ms": statistics.median(
             h["ms"] for h in history[1:]),
         "launches": launches, "peak_allocated_gib": peak_gb})
    return launches


def _audio(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((0.5 * np.tanh(rng.standard_normal(shape)))
                            .astype(np.float32))


def phase_train_profile(dev, mel_kw):
    """One training step at batch 16 under torch.profiler, after a warm-up
    step on the same models; then one step between two CUDA events, whose
    device span is set beside the host's wall time of the same step."""
    from radtts_tpu_torch.train.vocoder_trainer import (
        make_optimizers, make_vocoder_train_step, vocoder_train_init)

    models = vocoder_train_init(HIFIGAN_V1, seed=1).to(dev)
    step = make_vocoder_train_step(mel_kw, *make_optimizers(models))
    audio = _audio((TRAIN_BATCH, SEGMENT), 6).to(dev)

    def one_step():
        return {k: float(v) for k, v in step(models, audio).items()}

    one_step()
    profile = profile_run(one_step)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    tic = time.perf_counter()
    start.record()
    one_step()
    end.record()
    end.synchronize()
    log({"phase": "profile_train_step", "batch": TRAIN_BATCH, **profile,
         "events_step_device_span_ms": start.elapsed_time(end),
         "events_step_wall_ms": (time.perf_counter() - tic) * 1e3})


def phase_train_vs_cpu(dev, mel_kw, lr=2e-4):
    """One step at batch 2, full widths, from the same state on the card,
    on the CPU plain path, and on the CPU plain path in float64.

    Limits: the five losses within rtol 1e-3 of the CPU's; each generator
    gradient (still held after the step) no further from the float64
    step's, in norm, |g - g64| / |g64|, than max(1e-3, twice the CPU fp32
    step's own distance); the updated parameters within 2 * lr of the
    CPU's, with at most 1e-3 of each model's parameters apart by more than
    0.1 * lr. Adam's first update is ~lr * sign(grad) whatever the
    gradient's size, so the update alone cannot tell a wrong gradient from
    a right one; a zero or sign-flipped gradient is 1 or 2 away in norm and
    moves nearly every parameter ~lr away. The gradient is held against
    float64 because at random init it is ill-conditioned in fp32: the
    generated audio is ~1e-5, most of its mel bins sit on the log's clamp,
    and the bins just above it, whose gradient is 1/x, come and go with
    rounding, so two fp32 steps differ by up to ~1e-3 in norm."""
    from radtts_tpu_torch.train.vocoder_trainer import (
        make_optimizers, make_vocoder_train_step, vocoder_train_init)

    models_cpu = vocoder_train_init(HIFIGAN_V1, seed=2)
    models = {"card": copy.deepcopy(models_cpu).to(dev), "cpu": models_cpu,
              "cpu64": copy.deepcopy(models_cpu).double()}
    audio = _audio((2, SEGMENT), 7)
    out = {}
    for name, m in models.items():
        step = make_vocoder_train_step(mel_kw, *make_optimizers(m, lr=lr))
        p0 = next(m.parameters())
        tic = time.perf_counter()
        out[name] = {k: float(v) for k, v in step(
            m, audio.to(p0.device, p0.dtype)).items()}
        out[name + "_ms"] = (time.perf_counter() - tic) * 1e3

    def grad_dist(name):
        return {k: ((p.grad.cpu().double() - q.grad).norm()
                    / q.grad.norm().clamp(min=1e-30)).item()
                for (k, p), q in zip(models[name]["gen"].named_parameters(),
                                     models["cpu64"]["gen"].parameters())}

    card, cpu = grad_dist("card"), grad_dist("cpu")
    over = {k: (card[k], cpu[k]) for k in card
            if card[k] > max(1e-3, 2 * cpu[k])}
    worst = max(card, key=card.get)
    update = {}
    for name in ("gen", "mpd", "msd"):
        diffs = torch.cat([(p.detach().cpu() - q.detach()).abs().flatten()
                           for p, q in zip(models["card"][name].parameters(),
                                           models["cpu"][name].parameters())])
        update[name] = {"max_abs_diff": diffs.max().item(),
                        "share_over_lr_10": (diffs > 0.1 * lr).float()
                        .mean().item()}
    log({"phase": "train_step_card_vs_cpu", **out, "lr": lr,
         "gen_grad_worst_vs_float64": {"tensor": worst, "card": card[worst],
                                       "cpu_fp32": cpu[worst]},
         "gen_grad_cpu_fp32_worst_vs_float64": max(cpu.values()),
         "gen_grad_tensors": len(card), "update": update})
    for k, v in out["cpu"].items():
        if not abs(out["card"][k] - v) <= 1e-3 * abs(v):
            raise AssertionError(f"{k}: card {out['card'][k]} vs cpu {v}")
    if over:
        raise AssertionError(f"generator gradients off the float64 step "
                             f"(card, cpu fp32): {over}")
    for name, u in update.items():
        if not (u["max_abs_diff"] <= 2 * lr + 1e-7
                and u["share_over_lr_10"] <= 1e-3):
            raise AssertionError(f"{name} update differs: {u}")

# ---------------------------------------------------------------------------
# RADTTS training: the MAS kernel, the training CLI at full
# width, its step time, and one step on the card against the CPU
# ---------------------------------------------------------------------------

DECODER_CONFIG = os.path.join(REPO, "configs", "config_ljs_decoder.json")
MAS_SHAPES = [((16, 512, 112), None),          # the flagship training batch
              ((3, 997, 61), ([997, 640, 180], [61, 40, 17])),   # ragged
              ((2, 120, 90), ([120, 50], [90, 90])),   # in_len > out_len
              ((2, 2500, 100), ([2500, 1700], [100, 64])),  # long
              # the warp kernel's choices in global scratch (T x K words
              # beside its ring exceed a block's shared memory)
              ((1, 7000, 200), None),
              # past 256 tokens: 16 tokens a lane (choices in shared
              # memory), then 32 (choices in global scratch)
              ((2, 400, 300), ([400, 260], [300, 211])),
              ((1, 2000, 600), None), ((1, 3000, 1000), None)]
# N > 1024 tokens: mas_route gives the block kernel
MAS_BLOCK_SHAPE = ((1, 300, 1100), ([300], [1037]))
RADTTS_STEP = (16, 112, 512)       # bench_train.py's (B, N, T)
RADTTS_TRAIN_WAVS, RADTTS_VAL_WAVS = 16, 2


def soft_attention(shape, lens, seed):
    """Soft attention as ConvAttention gives it: a softmax over each item's
    valid tokens of seeded logits, zero past them (CPU float32)."""
    B, T, N = shape
    rng = np.random.default_rng(seed)
    out_lens, in_lens = lens if lens else ([T] * B, [N] * B)
    logits = rng.normal(size=(B, T, N)) * 3.0
    pad = np.arange(N)[None, :] >= np.asarray(in_lens)[:, None]
    logits = np.where(pad[:, None, :], -np.inf, logits)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (torch.from_numpy((e / e.sum(-1, keepdims=True))
                             .astype(np.float32)),
            torch.as_tensor(out_lens), torch.as_tensor(in_lens))


def phase_mas_kernel(mas_mod, dev, power):
    """csrc/mas.cu against mas_plain on the card: at every MAS_SHAPES entry
    the warp kernel (the route mas_route names there; asserted: one warp
    launch), and the block kernel on the same inputs (route="block",
    its time "before"); then MAS_BLOCK_SHAPE, whose N > 1024 the planner
    gives the block kernel (asserted). The hard alignments must be equal.
    Times of all (CUDA events); the bound is the bytes floor (B*T*N fp32
    read and written at 3.35 TB/s; ~4 operations a cell are far below
    it), though what bounds the kernels is the dependence over frames."""
    rows = []
    shapes = [(s, l, False) for s, l in MAS_SHAPES] + [
        (*MAS_BLOCK_SHAPE, True)]
    for i, (shape, lens, forced) in enumerate(shapes):
        attn, out_lens, in_lens = soft_attention(shape, lens, 20 + i)
        attn, out_lens, in_lens = (attn.to(dev), out_lens.to(dev),
                                   in_lens.to(dev))
        B, T, N = shape
        before = (mas_mod.mas.launches, mas_mod.mas.block_launches)
        got = mas_mod.mas(attn, out_lens, in_lens)
        routed = (mas_mod.mas.launches - before[0],
                  mas_mod.mas.block_launches - before[1])
        want = mas_mod.mas_plain(attn, out_lens, in_lens)
        torch.cuda.synchronize()
        n_diff = int((got != want).sum())
        t_bytes = 2 * 4.0 * B * T * N / HBM_BYTES
        t_ops = 4.0 * B * T * N / FP32_FLOPS
        row = {"phase": "mas_kernel_vs_plain", "card": power,
               "shape": list(shape), "route": mas_mod.mas_route(N),
               "routed": routed, "cells_different": n_diff,
               "ones": int(want.sum()),
               "max_abs_err": (got - want).abs().max().item(),
               "ms": cuda_ms(lambda: mas_mod.mas(attn, out_lens, in_lens)),
               "plain_ms": cuda_ms(lambda: mas_mod.mas_plain(
                   attn, out_lens, in_lens), reps=3, warmup=1),
               "bound_ms": max(t_bytes, t_ops) * 1e3,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes_floor_ms": t_bytes * 1e3}
        if forced:
            row["block_smem_bytes"] = mas_mod._lib.radtts_mas_smem_bytes(T, N)
            want_routed = (0, 1)
        else:
            row["tokens_a_lane"] = mas_mod.warp_tokens_a_lane(N)
            row["warp_choices_in_smem"] = \
                mas_mod._lib.radtts_mas_warp_scratch_words(B, T, N) == 0
            old = mas_mod.mas_cuda(attn, out_lens, in_lens, route="block")
            torch.cuda.synchronize()
            row["before_cells_different"] = int((old != want).sum())
            row["before_ms"] = cuda_ms(lambda: mas_mod.mas_cuda(
                attn, out_lens, in_lens, route="block"))
            n_diff += row["before_cells_different"]
            want_routed = (1, 0)
        log(row)
        rows.append(row)
        if n_diff or routed != want_routed:
            raise AssertionError(f"mas at {shape}: {n_diff} cells differ "
                                 f"from mas_plain, routed {routed}")
    return rows


def write_train_dataset(root, seed=0):
    """RADTTS_TRAIN_WAVS + RADTTS_VAL_WAVS seeded int16 wavs of 2-6 s (a
    voiced tone with a glide, plus noise), their lengths ~0.065 s per
    character of texts from filelists/ (the first rows of the LJS training
    list), and both filelists under root. Returns the training_files and
    validation_files entries."""
    from scipy.io import wavfile

    sr = 22050
    os.makedirs(os.path.join(root, "wavs"))
    with open(os.path.join(REPO, "filelists",
                           "ljs_audiopath_text_speaker_train_filelist.txt"),
              encoding="utf-8") as f:
        texts = [line.split("|")[1] for line in f][
            :RADTTS_TRAIN_WAVS + RADTTS_VAL_WAVS]
    rng = np.random.default_rng(seed)
    rows = []
    for i, text in enumerate(texts):
        seconds = float(np.clip(0.065 * len(text), 2.0, 6.0))
        t = np.arange(int(seconds * sr)) / sr
        hz = 110.0 + 15.0 * i + 30.0 * np.sin(2 * np.pi * 0.5 * t)
        w = (0.3 * np.sin(2 * np.pi * np.cumsum(hz) / sr)
             * (0.6 + 0.4 * np.sin(2 * np.pi * 3.0 * t))
             + 0.02 * rng.standard_normal(t.size))
        wavfile.write(os.path.join(root, "wavs", f"{i}.wav"), sr,
                      (w * 32767).astype(np.int16))
        rows.append(f"{i}.wav|{text}|ljs\n")
    files = {}
    for key, name, part in (
            ("training_files", "train.txt", rows[:RADTTS_TRAIN_WAVS]),
            ("validation_files", "val.txt", rows[RADTTS_TRAIN_WAVS:])):
        with open(os.path.join(root, name), "w") as f:
            f.writelines(part)
        files[key] = {"LJS": {"basedir": root, "audiodir": "wavs",
                              "filelist": name, "lmdbpath": ""}}
    return files


def _mrf_counts(mrf_mod):
    """The launches of each MRF kernel: mrf_tc's 3xTF32 and one-pass
    builds, mrf_tf32, mrf_stack and mrf_conv (csrc/mrf.cu)."""
    return {"mrf_tc": mrf_mod.mrf.tc_launches,
            "mrf_tc_one_pass": mrf_mod.mrf.tc1_launches,
            "mrf_tf32": mrf_mod.mrf.tf32_launches,
            "mrf_stack": mrf_mod.mrf.stack_launches,
            "mrf_conv": mrf_mod.mrf.launches}


def _reset_mrf(mrf_mod):
    for name in ("launches", "tc_launches", "tc1_launches",
                 "tf32_launches", "stack_launches"):
        setattr(mrf_mod.mrf, name, 0)


def _counts(mas_mod, mel_mod, mrf_mod):
    from radtts_tpu_torch.ops.ar_scan import ar_scan
    from radtts_tpu_torch.ops.lstm import lstm_cuda
    return {"mas": mas_mod.mas.launches, "mel": mel_mod.mel.launches,
            **_mrf_counts(mrf_mod), "ar_scan": ar_scan.launches,
            "mas_block": mas_mod.mas.block_launches,
            "ar_scan_barrier": ar_scan.barrier_launches,
            "lstm": lstm_cuda.launches}


def _reset_counts(mas_mod, mel_mod, mrf_mod):
    from radtts_tpu_torch.ops.ar_scan import ar_scan
    from radtts_tpu_torch.ops.lstm import lstm_cuda
    mas_mod.mas.launches = 0
    mas_mod.mas.block_launches = 0
    mel_mod.mel.launches = 0
    _reset_mrf(mrf_mod)
    ar_scan.launches = 0
    ar_scan.barrier_launches = 0
    lstm_cuda.launches = 0


def phase_train_radtts(mas_mod, mel_mod, mrf_mod, dev, power, then=None):
    """python -m radtts_tpu_torch.train's main at full width, on a seeded
    dataset written here: config_ljs_decoder.json (8 flows, 1024-wide WN,
    batch 16) for 4 steps across both curriculum points (binarize from
    step 1, the KL loss from step 2), validating and checkpointing at
    steps 0 and 3; one step resumed from model_3; config_ljs_dap.json
    (use_amp=false, batch 16: the dataset holds 16 wavs) warm-started from
    model_3 for 2 steps with its unfreeze_modules durf0energyvpred, every
    other parameter checked equal to the warm start's; then one text
    served from that checkpoint by python -m radtts_tpu_torch.inference.
    The counts are set to 0 just before the first training run and read
    just after the last; mas must launch once per binarized step and per
    validation batch, the MRF and mel kernels never. The serving that
    follows is counted apart. `then(root, files, decoder_checkpoint,
    vocoder, vocoder_config, text)` runs before the files are removed, and
    its result is returned beside the launches (with the DAP checkpoint
    and its config as two more arguments)."""
    from radtts_tpu_torch.inference import main as inference_main
    from radtts_tpu_torch.models.hifigan import (Generator,
                                                 generator_to_reference)
    from radtts_tpu_torch.train import main as train_main

    unfrozen = ("dur_pred_layer", "f0_pred_module", "energy_pred_module",
                "v_pred_module", "v_embeddings")
    with tempfile.TemporaryDirectory() as root:
        files = write_train_dataset(os.path.join(root, "data"))
        configs = {}
        for name, path in (("decoder", DECODER_CONFIG), ("dap", CONFIG)):
            with open(path) as f:
                config = json.load(f)
            config["data_config"].update(
                files, betabinom_cache_path=os.path.join(root, "cache"))
            configs[name] = os.path.join(root, f"{name}.json")
            with open(configs[name], "w") as f:
                json.dump(config, f)
        # the data preflight warms the caches the training runs then read
        cache = os.path.join(root, "cache")
        pre_s, warmed = run_preflight(configs["decoder"], cache)
        n_wavs = RADTTS_TRAIN_WAVS + RADTTS_VAL_WAVS
        if sum(k.endswith(".npz") for k in warmed) != n_wavs:
            raise AssertionError(f"preflight warmed {sorted(warmed)}, "
                                 f"expected {n_wavs} f0 caches")
        out = {k: os.path.join(root, k) for k in ("dec", "res", "dap")}
        common = ["train_config.seed=0", "train_config.batch_size=16"]
        curriculum = ["train_config.binarization_start_iter=1",
                      "train_config.kl_loss_start_iter=2",
                      "train_config.iters_per_checkpoint=3"]
        runs = {}
        torch.cuda.reset_peak_memory_stats()
        _reset_counts(mas_mod, mel_mod, mrf_mod)
        tic = time.perf_counter()
        runs["decoder"] = train_main([
            "-c", configs["decoder"], "-p",
            f"train_config.output_directory={out['dec']}",
            "train_config.epochs=4", *common, *curriculum])
        runs["resume"] = train_main([
            "-c", configs["decoder"], "-p",
            f"train_config.output_directory={out['res']}",
            "train_config.epochs=5", *common, *curriculum,
            f"train_config.checkpoint_path={out['dec']}/model_3"])
        runs["dap"] = train_main([
            "-c", configs["dap"], "-p",
            f"train_config.output_directory={out['dap']}",
            "train_config.epochs=2", "train_config.use_amp=false",
            *common,
            f"train_config.warmstart_checkpoint_path={out['dec']}/model_3"])
        train_s = time.perf_counter() - tic
        launches = _counts(mas_mod, mel_mod, mrf_mod)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        after = cache_files(cache)
        rewritten = [k for k, t in warmed.items() if after.get(k) != t]
        new_f0 = [k for k in after if k not in warmed and k.endswith(".npz")]
        log({"phase": "preflight", "seconds": pre_s, "jobs": 2,
             "f0_caches": sum(k.endswith(".npz") for k in warmed),
             "prior_caches": sum(k.endswith("_prior.npy") for k in warmed),
             "rewritten_by_training": rewritten,
             "new_f0_caches_by_training": new_f0,
             "new_prior_caches_by_training": sum(
                 k.endswith("_prior.npy") for k in after
                 if k not in warmed)})
        if rewritten or new_f0:
            raise AssertionError(f"training did not read the warmed caches: "
                                 f"rewrote {rewritten}, new f0 {new_f0}")
        # serve one text from the trained checkpoint: a serving path, with
        # counts of its own (72 mrf_tc launches per generator call: the
        # denoiser's bias call at load, then the text)
        _reset_counts(mas_mod, mel_mod, mrf_mod)
        torch.manual_seed(7)
        vocoder = Generator(HIFIGAN_V1)
        voc = os.path.join(root, "hifigan.pt")
        torch.save({"generator": generator_to_reference(vocoder)}, voc)
        voc_cfg = os.path.join(root, "hifigan.json")
        with open(voc_cfg, "w") as f:
            json.dump(HIFIGAN_V1, f)
        text = os.path.join(root, "text.txt")
        with open(text, "w") as f:
            f.write(TEXTS[1] + "\n")
        tic = time.perf_counter()
        written = inference_main([
            "-c", configs["dap"], "-r", f"{out['dap']}/model_0", "-v", voc,
            "-k", voc_cfg, "-t", text, "-s", "ljs", "-o",
            os.path.join(root, "wavs_out"), "--seed", "0"])
        serve_s = time.perf_counter() - tic
        serve_launches = _counts(mas_mod, mel_mod, mrf_mod)
        audio = _check_wav(written[0], written[0])

        src = torch.load(f"{out['dec']}/model_3", map_location="cpu",
                         weights_only=True)["model"]
        got = torch.load(f"{out['dap']}/model_0", map_location="cpu",
                         weights_only=True)["model"]
        frozen_equal = moved = 0
        for k, v in got.items():
            if k.split(".")[0] in unfrozen or k not in src:
                moved += int(k in src and not torch.equal(v, src[k]))
                continue
            if "sn_u" in k or "sn_v" in k or k.endswith(".p"):
                continue     # buffers: the power iteration moves sn_u, sn_v
            if not torch.equal(v, src[k]):
                raise AssertionError(f"{k} moved in the frozen DAP run")
            frozen_equal += 1
        after = None if then is None else then(
            root, files, f"{out['dec']}/model_3", voc, voc_cfg, text,
            f"{out['dap']}/model_0", configs["dap"])

    history = [dict(h, run=name) for name, hs in runs.items() for h in hs]
    for h in history:
        vals = [v for v in h.values() if isinstance(v, float)]
        if not all(np.isfinite(vals)):
            raise AssertionError(f"non-finite step {h}")
    # binarized steps: decoder iterations 1-3, the resumed 4, both DAP steps;
    # validations: decoder at 0 and 3, DAP at 0, one batch each. The LSTM
    # kernel takes the runs that want no gradient (the validations', the
    # frozen modules' of the DAP run); the others run cuDNN
    want_mas = 3 + 1 + 2 + 3
    curr = [(h["binarize"], h["use_kl"]) for h in runs["decoder"]]
    if (curr != [(False, False), (True, False), (True, True), (True, True)]
            or [h["iteration"] for h in runs["resume"]] != [4]
            or len(runs["dap"]) != 2
            or launches != {"mas": want_mas, "mel": 0, "mrf_tc": 0,
                            "mrf_tc_one_pass": 0, "mrf_tf32": 0,
                            "mrf_stack": 0, "mrf_conv": 0, "ar_scan": 0,
                            "mas_block": 0, "ar_scan_barrier": 0,
                            "lstm": 13}
            or serve_launches != {"mas": 0, "mel": 0, "mrf_tc": 2 * 72,
                                  "mrf_tc_one_pass": 0, "mrf_tf32": 0,
                                  "mrf_stack": 0, "mrf_conv": 0,
                                  "ar_scan": 0,
                                  "mas_block": 0, "ar_scan_barrier": 0,
                                  "lstm": DAP_CALL_LSTMS}
            or frozen_equal < 100):
        raise AssertionError(f"curriculum {curr}, launches {launches}, "
                             f"serving {serve_launches}, {frozen_equal} "
                             "frozen parameters equal")
    log({"phase": "train_radtts", "card": power,
         "steps": [{k: h[k] for k in ("run", "iteration", "ms", "total",
                                      "grad_norm", "binarize", "use_kl",
                                      "loss_mel", "loss_ctc",
                                      "binarization_loss")}
                   for h in history],
         "steady_step_ms_decoder": statistics.median(
             h["ms"] for h in runs["decoder"][1:]),
         "dap_step_ms": [h["ms"] for h in runs["dap"]],
         "validation": {name: [h["validation"] for h in hs
                               if "validation" in h]
                        for name, hs in runs.items()},
         "cli_seconds": train_s, "serve_seconds": serve_s,
         "served_samples": int(audio.size),
         "dap_parameters_moved": moved,
         "frozen_parameters_equal": frozen_equal,
         "launches": launches, "serve_launches": serve_launches,
         "peak_allocated_gib": peak_gib})
    return launches, after


def radtts_step_batch(B, N, T, n_mel, seed, in_lens=None, out_lens=None):
    """bench_train.py's batch (seeded numpy: random mel, text, f0 and
    voicing, energy; every item N tokens and T frames unless lengths are
    given) with a beta-binomial prior over each item's valid region in
    place of its random one."""
    from radtts_tpu_torch.data.dataset import \
        beta_binomial_prior_distribution

    r = np.random.default_rng(seed)
    in_lens = np.full((B,), N, np.int64) if in_lens is None else \
        np.asarray(in_lens, np.int64)
    out_lens = np.full((B,), T, np.int64) if out_lens is None else \
        np.asarray(out_lens, np.int64)
    f0 = (r.random((B, T)) * 300 + 100).astype(np.float32)
    voiced = (r.random((B, T)) > 0.3).astype(np.float32)
    prior = np.zeros((B, T, N), np.float32)
    for b, (n, t) in enumerate(zip(in_lens, out_lens)):
        prior[b, :t, :n] = beta_binomial_prior_distribution(n, t, 1.0)
    return {
        "mel": r.standard_normal((B, T, n_mel)).astype(np.float32),
        "speaker_ids": np.zeros((B,), np.int64),
        "text": r.integers(1, 180, (B, N)).astype(np.int64),
        "input_lengths": in_lens, "output_lengths": out_lens,
        "attn_prior": prior, "f0": f0 * voiced, "voiced_mask": voiced,
        "energy_avg": r.random((B, T)).astype(np.float32)}


def _radtts_trainer(model_config, dev, seed, lr=1e-4, unfreeze="all"):
    from radtts_tpu_torch.train.trainer import (apply_trainable_mask,
                                                build_trainable_mask,
                                                init_model)
    from radtts_tpu_torch.train.optim import build_optimizer

    model = init_model(model_config, seed, dev)
    trainable = apply_trainable_mask(model, build_trainable_mask(
        model, unfreeze))
    return model, trainable, build_optimizer(trainable, "RAdam", lr, 1e-6)


def phase_radtts_step(mas_mod, dev, power):
    """The config_ljs_dap.json model, every module trainable, binarize and
    the KL loss on, fp32, at bench_train.py's (16, 112, 512): wall ms of a
    step (host clock around the step and its synchronize; median of steps
    2-5), mel frames per second, the peak memory, then one step under
    torch.profiler (device busy and idle share, top kernels), then one
    step's counted FLOP (ops/flops.py) over the median step time."""
    from radtts_tpu_torch.ops import flops
    from radtts_tpu_torch.train.trainer import batch_to_device, train_step

    with open(CONFIG) as f:
        config = json.load(f)
    mc, tc = config["model_config"], config["train_config"]
    B, N, T = RADTTS_STEP
    model, trainable, opt = _radtts_trainer(mc, dev, seed=1)
    batch = batch_to_device(radtts_step_batch(
        B, N, T, mc["n_mel_channels"], 2), dev)

    def one_step():
        total, _, _ = train_step(model, opt, trainable, batch, mc,
                                 tc["loss_weights"], 1.0, True, True,
                                 tc["grad_clip_val"])
        return float(total)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, totals = [], []
    for _ in range(6):
        total, t = timed(one_step)
        ms.append(t)
        totals.append(total)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    launches_before = mas_mod.mas.launches
    profile = profile_run(one_step, top=15)
    step_ms = statistics.median(ms[1:5])
    step_flop = flops.count_matmul_flops(one_step)
    log({"phase": "radtts_train_step", "card": power, "batch": [B, N, T],
         "step_ms": ms, "median_step_ms_2_5": step_ms,
         "mel_frames_per_s": B * T / (step_ms / 1e3),
         "peak_allocated_gib": peak_gib, "losses": totals,
         "profile": profile,
         "mas_launches_in_profiled_step": mas_mod.mas.launches
         - launches_before})
    log({"phase": "radtts_train_step_flops", "card": power,
         "batch": [B, N, T], "gflop": step_flop / 1e9,
         "median_step_ms_2_5": step_ms,
         "tflops": step_flop / step_ms / 1e9})
    if not step_flop > 0:
        raise AssertionError("the RADTTS step counted no FLOP")
    if not all(np.isfinite(totals)):
        raise AssertionError(f"non-finite losses {totals}")
    return step_ms


def phase_radtts_vs_cpu(dev, lr=1e-4, config_path=CONFIG, unfreeze="all",
                        phase="radtts_train_step_card_vs_cpu"):
    """One step at batch 2 of the config_path model (full widths, binarize
    and KL on; the config_ljs_dap.json model with every module trainable,
    or as unfreeze says) from the same state, on the card, on the CPU and on
    the CPU in float64. The card's hard alignment (csrc/mas.cu) must equal
    mas_plain's on the CPU's own soft attention, or the near-tie that
    split them is reported; the CPU steps then take the card's alignment,
    so that the gradients differ only by arithmetic. Limits: the losses
    within rtol 1e-3 of the CPU's; each trainable gradient (the clipped
    one the step applied) no further from the float64 step's, in norm,
    than max(1e-3, twice the CPU fp32 step's own distance). The distance is
    relative to the float64 gradient's norm, or to 1e-3 of the global
    float64 norm where that is larger: some exact gradients are 0 (a conv
    bias before an instance norm), and fp32 leaves rounding there."""
    import radtts_tpu_torch.models.radtts as radtts_mod
    from radtts_tpu_torch.ops.mas import mas_plain
    from radtts_tpu_torch.train.trainer import train_step

    with open(config_path) as f:
        config = json.load(f)
    mc, tc = config["model_config"], config["train_config"]
    from radtts_tpu_torch.train.optim import build_optimizer

    B, N, T = 2, 48, 192
    batch = radtts_step_batch(B, N, T, mc["n_mel_channels"], 3, [48, 37],
                              [192, 150])
    cpu_model = _radtts_trainer(mc, "cpu", seed=4, lr=lr,
                                unfreeze=unfreeze)[0]
    runs = {"card": (copy.deepcopy(cpu_model).to(dev), torch.float32),
            "cpu": (cpu_model, torch.float32),
            "cpu64": (copy.deepcopy(cpu_model).double(), torch.float64)}
    real_binarize = radtts_mod.binarize_attention
    seen = {}
    out = {}
    for name, (model, dtype) in runs.items():
        p0 = next(model.parameters())
        trainable = [p for p in model.parameters() if p.requires_grad]
        opt = build_optimizer(trainable, "RAdam", lr, 1e-6)
        tb = {k: (torch.from_numpy(v).to(dtype) if v.dtype == np.float32
                  else torch.from_numpy(v)).to(p0.device)
              for k, v in batch.items()}

        def binarize(attn_soft, in_lens, out_lens, name=name):
            seen[name + "_soft"] = attn_soft.detach().float().cpu()
            if name == "card":
                hard = real_binarize(attn_soft, in_lens, out_lens)
                seen["card_hard"] = hard.cpu()
                return hard
            return seen["card_hard"].to(attn_soft.device, attn_soft.dtype)

        radtts_mod.binarize_attention = binarize
        try:
            tic = time.perf_counter()
            total, loss_dict, _ = train_step(
                model, opt, trainable, tb, mc, tc["loss_weights"], 1.0,
                True, True, tc["grad_clip_val"])
            out[name] = {k: float(v.detach()) for k, (v, _) in
                         loss_dict.items()}
            out[name]["total"] = float(total)
            out[name + "_ms"] = (time.perf_counter() - tic) * 1e3
        finally:
            radtts_mod.binarize_attention = real_binarize
    cpu_hard = mas_plain(seen["cpu_soft"], torch.from_numpy(
        batch["output_lengths"]), torch.from_numpy(batch["input_lengths"]))
    n_diff = int((cpu_hard != seen["card_hard"]).sum())
    soft_diff = (seen["card_soft"] - seen["cpu_soft"]).abs().max().item()

    ref = [q.grad for q in runs["cpu64"][0].parameters() if q.requires_grad]
    floor = 1e-3 * torch.stack([g.norm() for g in ref]).norm()

    def grad_dist(name):
        model = runs[name][0]
        return {k: ((p.grad.cpu().double() - q).norm()
                    / torch.maximum(q.norm(), floor)).item()
                for (k, p), q in zip(((k, p) for k, p in
                                      model.named_parameters()
                                      if p.requires_grad), ref)}

    card, cpu = grad_dist("card"), grad_dist("cpu")
    over = {k: (card[k], cpu[k]) for k in card
            if card[k] > max(1e-3, 2 * cpu[k])}
    worst = max(card, key=card.get)
    log({"phase": phase, **out,
         "alignment_cells_different": n_diff,
         "soft_attention_max_abs_diff": soft_diff,
         "grad_worst_vs_float64": {"tensor": worst, "card": card[worst],
                                   "cpu_fp32": cpu[worst]},
         "grad_cpu_fp32_worst_vs_float64": max(cpu.values()),
         "grad_tensors": len(card)})
    if n_diff:
        log({"phase": "radtts_alignment_near_tie", "cells": n_diff,
             "soft_attention_max_abs_diff": soft_diff})
    for k, v in out["cpu"].items():
        if not abs(out["card"][k] - v) <= 1e-3 * abs(v) + 1e-6:
            raise AssertionError(f"{k}: card {out['card'][k]} vs cpu {v}")
    if over:
        raise AssertionError(f"gradients off the float64 step (card, cpu "
                             f"fp32): {over}")



AGAP_CONFIG = os.path.join(REPO, "configs", "config_ljs_agap.json")
BGAP_CONFIG = os.path.join(REPO, "configs", "config_ljs_bgap.json")
GAP_CONFIGS = {"bgap": BGAP_CONFIG, "agap": AGAP_CONFIG}
# (B, T), valid lengths (None: all T), head: the published AGAP step at
# the flagship length, ragged batches (B = 8 fills the kernel's group of 8
# items; B = 16 takes a second group, as the serving daemon's --max_batch
# above 8 does), and the other two heads at small T
AR_SHAPES = [((1, MAX_FRAMES), None, "quadratic"),
             ((3, MAX_FRAMES), (608, 411, 97), "quadratic"),
             ((8, MAX_FRAMES), (608, 577, 501, 411, 320, 256, 97, 1),
              "quadratic"),
             ((16, MAX_FRAMES), None, "quadratic"),
             ((2, 96), None, "linear"), ((2, 96), (96, 41), "affine")]
AR_BLOCKS = [66, 88, 110, 132]
FP32_FLOPS = 67e12          # H100 SXM fp32 outside the tensor cores


def ar_step_at_width(head, dev, seed=0):
    """The first AR step of config_ljs_agap.json's f0 model at its
    published width (C=1, H=128, context 32 + 16, the 128 -> 256 -> 512 ->
    1024 -> 1024 -> 49 spline head), seeded, its zero-initialised last
    layer drawn at sd 0.02 (else the step is the identity); head "linear"
    or "affine" swaps the spline for the linear one (24 bins) or the dense
    affine head."""
    from radtts_tpu_torch.models.attributes import attribute_model
    from radtts_tpu_torch.models.radtts import attribute_config

    with open(AGAP_CONFIG) as f:
        mc = json.load(f)["model_config"]
    cfg = attribute_config(mc["f0_model_config"], False)
    hp = cfg["hparams"]
    if head == "linear":
        hp["spline_flow_params"] = dict(hp["spline_flow_params"],
                                        use_quadratic=False)
    elif head == "affine":
        hp["spline_flow_params"] = None
    torch.manual_seed(seed)
    step = attribute_model(cfg, n_speaker_dim=mc["n_speaker_dim"]).flows[0]
    last = (step.spline_flow.pred.last if step.spline_flow is not None
            else step.conv)
    with torch.no_grad():
        torch.nn.init.normal_(last.weight, std=0.02)
        torch.nn.init.normal_(last.bias, std=0.02)
    return step.to(dev).eval().requires_grad_(False)


def ar_inputs(step, shape, lens, dev, seed):
    """(scan params, residual, context_proj) of seeded inputs, zero past
    each valid length (as the back steps' reversal leaves them)."""
    B, T = shape
    gen = torch.Generator().manual_seed(seed)
    res = torch.randn(B, T, step.n_attr, generator=gen) * 0.8
    n_ctx = step.lstm.lstm.input_size - step.lstm.lstm.hidden_size
    ctx = torch.randn(B, T, n_ctx, generator=gen)
    if lens is not None:
        valid = (torch.arange(T)[None, :]
                 < torch.as_tensor(lens)[:, None])[:, :, None]
        res, ctx = res * valid, ctx * valid
    res, ctx = res.to(dev), ctx.to(dev)
    w_ih, _, (b_ih, b_hh) = step.lstm.weights(0)
    H = step.lstm.lstm.hidden_size
    return (step.scan_params("tanh"), res,
            torch.matmul(ctx, w_ih[:, H:].T) + (b_ih + b_hh))


def ar_bound(params, B, T, C):
    """(bound ms, bound_by, MFLOP, MB): the larger of the FLOP at the fp32
    rate and the bytes (the weights once, residual, context_proj and the
    output) at the HBM rate."""
    from radtts_tpu_torch.ops import ar_scan as ar_mod

    flop = 2.0 * B * T * ar_mod.macs_per_frame(params, C)
    H = params["attr"][1].shape[1]
    nbytes = ar_mod.weight_bytes(params) + 4 * B * T * (2 * C + 4 * H)
    t_flop, t_bytes = flop / FP32_FLOPS * 1e3, nbytes / HBM_BYTES * 1e3
    return (max(t_flop, t_bytes),
            "operations" if t_flop >= t_bytes else "bytes",
            flop / 1e6, nbytes / 1e6)


def _ar_counts(ar_mod):
    return (ar_mod.ar_scan.launches, ar_mod.ar_scan.barrier_launches)


def _routed(ar_mod, before):
    """(resident, barrier) launches since `before`."""
    now = _ar_counts(ar_mod)
    return (now[0] - before[0], now[1] - before[1])


def phase_ar_scan_kernel(ar_mod, dev, power):
    """The resident kernel of csrc/ar_scan.cu, the route ar_scan_plan names
    at every AR_SHAPES entry (asserted: one resident launch, no barrier-kernel
    launch), against ar_scan_plain on the card within 1e-4 * max|plain|
    (fp32 mat-vecs summed in another order over a recurrence), the step
    acting (output off the residual); its time beside the barrier kernel's on
    the same inputs ("before", also held against plain), the plain
    version's, the bound and the us per frame; then the resident kernel's
    block count swept at (1, 608), each output within the same limit of
    the default's; then a second step of other weights, built where the
    first was freed, against its own plain version."""
    rows = []
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for shape, lens, head in AR_SHAPES:
        step = ar_step_at_width(head, dev)
        params, res, cproj = ar_inputs(step, shape, lens, dev, seed=11)
        B, T = shape
        plan = ar_mod.ar_scan_plan([params], B, sms)
        with torch.no_grad():
            before = _ar_counts(ar_mod)
            got = ar_mod.ar_scan(params, res, cproj)
            routed = _routed(ar_mod, before)
            want = ar_mod.ar_scan_plain(params, res, cproj)
            old = ar_mod.ar_scan_cuda(params, res, cproj)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            old_err = (old - want).abs().max().item()
            scale = want.abs().max().item()
            moved = (want - res).abs().max().item()
            ms = cuda_ms(lambda: ar_mod.ar_scan(params, res, cproj))
            before_ms = cuda_ms(lambda: ar_mod.ar_scan_cuda(params, res,
                                                            cproj))
            plain_ms = cuda_ms(
                lambda: ar_mod.ar_scan_plain(params, res, cproj), reps=2,
                warmup=1, min_ms=0.0)
        bound_ms, bound_by, mflop, mb = ar_bound(params, B, T, res.shape[2])
        row = {"shape": [B, T, res.shape[2]], "lens": lens, "head": head,
               "route": plan[0]["route"], "blocks": plan[0]["blocks"],
               "smem_bytes": plan[0]["smem"],
               "weight_bytes_per_block_max": 4 * int(
                   plan[0]["plans"][0]["img_floats"].max()),
               "handoffs_per_frame": len(params["lstm"])
               + len(params["head"]),
               "ms": ms, "before_ms": before_ms, "plain_ms": plain_ms,
               "us_per_frame": ms * 1e3 / T,
               "before_us_per_frame": before_ms * 1e3 / T,
               "bound_ms": bound_ms, "bound_by": bound_by, "mflop": mflop,
               "mbytes": mb, "max_abs_err": err, "before_max_abs_err": old_err,
               "max_abs_plain": scale, "max_change": moved,
               "library_ms": None}
        log({"phase": "ar_scan_kernel_vs_plain", "card": power, **row})
        if (routed != (1, 0) or plan[0]["route"] != "resident"
                or not err <= 1e-4 * scale or not old_err <= 1e-4 * scale
                or not moved > 1e-2):
            raise AssertionError(f"ar_scan at {shape} {head}: routed "
                                 f"{routed}, err {err} (barrier kernel "
                                 f"{old_err}) of {scale}, change {moved}")
        rows.append(row)
    step = ar_step_at_width("quadratic", dev)
    params, res, cproj = ar_inputs(step, AR_SHAPES[0][0], None, dev, 11)
    sweep = []
    with torch.no_grad():
        ref = ar_mod.ar_scan(params, res, cproj)
        for nb in AR_BLOCKS:
            before = _ar_counts(ar_mod)
            out = ar_mod.ar_scan_multi([(params, res, cproj)], blocks=nb)[0]
            if _routed(ar_mod, before) != (1, 0):
                continue             # the weights do not fit nb blocks
            diff = (out - ref).abs().max().item()
            ms = cuda_ms(lambda: ar_mod.ar_scan_multi(
                [(params, res, cproj)], blocks=nb))
            sweep.append({"blocks": nb, "ms": ms,
                          "us_per_frame": ms * 1e3 / MAX_FRAMES,
                          "max_abs_diff_vs_default": diff})
            if not diff <= 1e-4 * ref.abs().max().item():
                raise AssertionError(f"ar_scan blocks={nb}: {diff}")
    log({"phase": "ar_scan_blocks", "card": power, "shape": [1, MAX_FRAMES],
         "sweep": sweep})
    # a second step built where the first was freed (the caching allocator
    # hands it the same blocks): the kernel must run the second's weights
    del step, params, ref, out
    outs = {}
    for seed in (0, 1):
        step = ar_step_at_width("quadratic", dev, seed=seed)
        params, res, cproj = ar_inputs(step, AR_SHAPES[0][0], None, dev, 11)
        with torch.no_grad():
            outs[seed] = ar_mod.ar_scan(params, res, cproj)
            want = ar_mod.ar_scan_plain(params, res, cproj)
        err = (outs[seed] - want).abs().max().item()
        if not err <= 1e-4 * want.abs().max().item():
            raise AssertionError(f"ar_scan, step of seed {seed} built after "
                                 f"another was freed: err {err}")
        del step, params, cproj, want
    apart = (outs[1] - outs[0]).abs().max().item()
    log({"phase": "ar_scan_second_model", "max_abs_err": err,
         "max_abs_diff_between_models": apart})
    if not apart > 1e-2:
        raise AssertionError(f"ar_scan: two models' outputs equal ({apart})")
    return rows, sweep


# (B, T), valid lengths: f0's and energy's steps paired in one launch
AR_PAIRS = [((1, MAX_FRAMES), None), ((8, MAX_FRAMES),
                                      (608, 577, 501, 411, 320, 256, 97, 1)),
            ((16, MAX_FRAMES), None)]
AR_APART = ((24, 96), None)      # the pair does not fit one launch: two


def phase_ar_scan_pair(ar_mod, dev, power):
    """Two published AGAP steps of other weights (f0's and energy's shape)
    at AR_PAIRS: one resident launch of both (asserted) against the two
    run one after the other (two launches) and against plain, within 1e-4
    * max; both times. Then AR_APART, where the planner names a resident
    launch each (asserted: two launches, no barrier-kernel launch)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    steps = [ar_step_at_width("quadratic", dev, seed=s) for s in (0, 1)]
    rows = []
    for shape, lens in AR_PAIRS + [AR_APART]:
        problems = [ar_inputs(st, shape, lens, dev, seed=11 + k)
                    for k, st in enumerate(steps)]
        plan = ar_mod.ar_scan_plan([p[0] for p in problems], shape[0], sms)
        with torch.no_grad():
            before = _ar_counts(ar_mod)
            pair = ar_mod.ar_scan_multi(problems)
            routed = _routed(ar_mod, before)
            alone = [ar_mod.ar_scan(*p) for p in problems]
            plain = [ar_mod.ar_scan_plain(*p) for p in problems]
            torch.cuda.synchronize()
            scale = max(w.abs().max().item() for w in plain)
            err = max((g - w).abs().max().item() for g, w in zip(pair, plain))
            vs_alone = max((g - a).abs().max().item()
                           for g, a in zip(pair, alone))
            pair_ms = cuda_ms(lambda: ar_mod.ar_scan_multi(problems))
            alone_ms = cuda_ms(lambda: [ar_mod.ar_scan(*p)
                                        for p in problems])
        B, T = shape
        bound = [ar_bound(p[0], B, T, 1) for p in problems]
        row = {"shape": [B, T, 1], "lens": lens,
               "routes": [lc["route"] for lc in plan],
               "launches": [lc["problems"] for lc in plan],
               "blocks": [[pl["blocks"] for pl in lc["plans"]] for lc in plan],
               "smem_bytes": [lc["smem"] for lc in plan],
               "paired_ms": pair_ms, "two_launches_ms": alone_ms,
               "bound_ms": sum(b[0] for b in bound),
               "max_abs_err": err, "max_abs_diff_vs_alone": vs_alone,
               "max_abs_plain": scale, "routed": routed}
        log({"phase": "ar_scan_pair", "card": power, **row})
        want = (len(plan), 0)
        if (routed != want or not err <= 1e-4 * scale
                or not vs_alone <= 1e-4 * scale
                or (shape != AR_APART[0]) != (len(plan) == 1)):
            raise AssertionError(f"ar_scan pair at {shape}: {row}")
        rows.append(row)
    return rows


def wide_step(dev, H=1024, seed=3):
    """A step no configuration gives: H = 1024 with the dense affine head
    (~50 MB of weights, more than 132 blocks' shared memory), seeded."""
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return (torch.randn(*shape, generator=gen)
                / math.sqrt(shape[-1])).to(dev)
    return {"attr": (rnd(4 * H, 1), rnd(4 * H, H),
                     (rnd(4 * H), rnd(4 * H))),
            "lstm": [(rnd(4 * H, H), rnd(4 * H, H), None)],
            "head": [(rnd(H, H), rnd(H), "tanh"), (rnd(2, H), rnd(2), None)],
            "kind": "affine", "scaling_fn": "tanh"}


AR_SPLIT_H = (1024, 1022)      # wide_step's widths (1022: padded to 1024)
AR_SPLIT_SHAPE = (1, 32)
L2_PROBE_BYTES = 32 * 2 ** 20          # a tensor that fits the 50 MB L2
L2_PROBE_PASSES = 16


def l2_read_rate(dev):
    """Bytes/s of one reduction that reads a 32 MB tensor 16 times over (an
    expanded view of one storage, which stays in the 50 MB L2): the L2 read
    rate the split route's chain floor divides its overflow by. One launch,
    so launch gaps do not count."""
    t = torch.ones(L2_PROBE_BYTES // 4, device=dev).expand(L2_PROBE_PASSES,
                                                          -1)
    return L2_PROBE_PASSES * L2_PROBE_BYTES / (
        cuda_ms(lambda: t.sum(1)) * 1e-3)


def split_kernel_ms_and_frame(ar_mod, params, res, cproj, n_phases, dev,
                              calls=5):
    """(ms, frame) of the split route's kernel alone: its device time per
    call under the profiler over `calls` calls of ar_scan (the rest of a
    call is the weight gather and the plan's copies), and block 0's traced
    frame in us (mean over the frames but the first and the last: the
    attribute LSTM, then each phase's rows, its handoff and its load, then
    the inverse)."""
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        ar_mod.ar_scan(params, res, cproj)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                ar_mod.ar_scan(params, res, cproj)
            torch.cuda.synchronize()
        trace = ar_mod.trace_buffer(dev)
        ar_mod.ar_scan_multi([(params, res, cproj)], trace=trace)
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", 0) for e in prof.key_averages()
             if "ar_scan_resident_kernel" in e.key)
    T = res.shape[1]
    tr = trace.cpu().numpy()[:T].astype(np.float64) / 1e3
    frames = slice(1, T - 1)

    def mean(a, b):
        return float(np.mean(tr[frames, b] - tr[frames, a]))
    return us / calls / 1e3, {
        "frame_us": float(np.mean(tr[2:T, 0] - tr[1:T - 1, 0])),
        "attr_us": mean(0, 1),
        "phases": [{"rows_us": mean(1 if p == 0 else 3 * p + 1, 3 * p + 2),
                    "handoff_us": mean(3 * p + 2, 3 * p + 3),
                    "load_us": mean(3 * p + 3, 3 * p + 4)}
                   for p in range(n_phases)],
        "inverse_us": mean(3 * n_phases + 1, 3 * n_phases + 2)}


def phase_ar_scan_split_route(ar_mod, dev, power):
    """wide_step at (1, 32), H = 1024 and 1022 (whose widths pad_widths
    pads to 1024): the planner names the split route, by shape (asserted:
    one launch of the resident kernel, none of the barrier kernel), within
    1e-4 * max of plain; the kernel's time beside the barrier kernel on
    the same inputs (before, held to the same limit), the plain version's
    and the bound (the FLOP at 67 TFLOP/s fp32 or the weights' bytes once
    at 3.35 TB/s, as ar_bound counts them) and the split route's chain
    floor: the overflow bytes a frame over the L2 read rate (l2_read_rate)
    plus the handoff probe's time for the same frames and phases on the
    same grid; the kernel's own device time (the rest of a call is the
    weight gather) and block 0's traced frame."""
    rows = []
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    l2_rate = l2_read_rate(dev)
    B, T = AR_SPLIT_SHAPE
    for H in AR_SPLIT_H:
        params = wide_step(dev, H=H)
        gen = torch.Generator().manual_seed(4)
        res = (torch.randn(B, T, 1, generator=gen) * 0.8).to(dev)
        cproj = torch.randn(B, T, 4 * H, generator=gen).to(dev)
        plan = ar_mod.ar_scan_plan([params], B, sms)
        pl = plan[0]["plans"][0]
        with torch.no_grad():
            before = _ar_counts(ar_mod)
            got = ar_mod.ar_scan(params, res, cproj)
            routed = _routed(ar_mod, before)
            want = ar_mod.ar_scan_plain(params, res, cproj)
            old = ar_mod.ar_scan_cuda(params, res, cproj)
            torch.cuda.synchronize()
            ms = cuda_ms(lambda: ar_mod.ar_scan(params, res, cproj))
            before_ms = cuda_ms(lambda: ar_mod.ar_scan_cuda(params, res,
                                                            cproj))
            plain_ms = cuda_ms(lambda: ar_mod.ar_scan_plain(
                params, res, cproj), reps=3, warmup=1)
        err = (got - want).abs().max().item()
        old_err = (old - want).abs().max().item()
        scale = want.abs().max().item()
        n_phases = len(params["lstm"]) + len(params["head"])
        kernel_ms, frame = split_kernel_ms_and_frame(
            ar_mod, params, res, cproj, n_phases, dev)
        ar_mod.handoff_probe(n_phases, T, "handoff", plan[0]["blocks"],
                             plan[0]["smem"], dev)
        probe_ms = cuda_ms(lambda: ar_mod.handoff_probe(
            n_phases, T, "handoff", plan[0]["blocks"], plan[0]["smem"],
            dev))
        ovf_bytes = 4.0 * float(pl["ovf_floats"].sum())
        bound_ms, bound_by, mflop, mbytes = ar_bound(params, B, T, 1)
        row = {"shape": [B, T, 1], "H": H, "padded_H": pl["H"],
               "route": plan[0]["route"], "routed": routed,
               "blocks": plan[0]["blocks"], "smem_bytes": plan[0]["smem"],
               "kept_weight_bytes_per_block_max": 4 * int(
                   pl["img_floats"].max()),
               "overflow_bytes_per_frame": ovf_bytes,
               "streamed_units": sum(n for *_, n in pl["streamed"]),
               "max_abs_err": err, "before_max_abs_err": old_err,
               "max_abs_plain": scale,
               "weight_bytes": ar_mod.weight_bytes(params), "ms": ms,
               "kernel_ms": kernel_ms, "frame_trace_us": frame,
               "before_ms": before_ms, "plain_ms": plain_ms,
               "us_per_frame": ms * 1e3 / T,
               "before_us_per_frame": before_ms * 1e3 / T,
               "bound_ms": bound_ms, "bound_by": bound_by, "mflop": mflop,
               "mbytes": mbytes, "l2_read_bytes_per_s": l2_rate,
               "handoff_probe_ms": probe_ms,
               "chain_floor_ms": T * ovf_bytes / l2_rate * 1e3 + probe_ms}
        log({"phase": "ar_scan_split_route", "card": power, **row})
        if (routed != (1, 0) or plan[0]["route"] != "split"
                or not err <= 1e-4 * scale or not old_err <= 1e-4 * scale):
            raise AssertionError(f"ar_scan split route: {row}")
        rows.append(row)
    return rows


def phase_ar_scan_trace(ar_mod, dev, power):
    """Where a resident launch's frame goes: block 0's clock at each phase
    boundary (ar_scan_multi(..., trace=)), one flow at (1, 608) and the
    f0 + energy pair at (1, 608); per frame (mean over frames 1..607, us):
    the attribute LSTM, then each phase's rows, its handoff (the wait for
    the slowest producer included) and its input's load, then the
    inverse. With the launch's time traced and not (the trace's cost)."""
    steps = [ar_step_at_width("quadratic", dev, seed=s) for s in (0, 1)]
    problems = [ar_inputs(st, (1, MAX_FRAMES), None, dev, seed=11 + k)
                for k, st in enumerate(steps)]
    out = {}
    for name, probs in (("one", problems[:1]), ("pair", problems)):
        n_phases = len(probs[0][0]["lstm"]) + len(probs[0][0]["head"])
        with torch.no_grad():
            trace = ar_mod.trace_buffer(dev)
            ar_mod.ar_scan_multi(probs, trace=trace)
            torch.cuda.synchronize()
            tr = trace.cpu().numpy()[:MAX_FRAMES].astype(np.float64) / 1e3
            plain = cuda_ms(lambda: ar_mod.ar_scan_multi(probs))
            traced = cuda_ms(lambda: ar_mod.ar_scan_multi(
                probs, trace=ar_mod.trace_buffer(dev)))
        frames = slice(1, MAX_FRAMES - 1)

        def mean(a, b):
            return float(np.mean(tr[frames, b] - tr[frames, a]))
        phases = [{"rows_us": mean(1 if p == 0 else 3 * p + 1, 3 * p + 2),
                   "handoff_us": mean(3 * p + 2, 3 * p + 3),
                   "load_us": mean(3 * p + 3, 3 * p + 4)}
                  for p in range(n_phases)]
        last = 3 * n_phases + 2
        out[name] = {
            "frame_us": float(np.mean(tr[2:MAX_FRAMES, 0]
                                      - tr[1:MAX_FRAMES - 1, 0])),
            "attr_us": mean(0, 1), "phases": phases,
            "inverse_us": mean(last - 1, last),
            "handoffs_us": sum(p["handoff_us"] for p in phases),
            "loads_us": sum(p["load_us"] for p in phases),
            "rows_us": sum(p["rows_us"] for p in phases),
            "ms": plain, "traced_ms": traced}
    log({"phase": "ar_scan_trace", "card": power, **out})
    return out


def phase_handoff_probe(ar_mod, dev, power, blocks, smem, n_phases, T):
    """csrc/ar_scan.cu's handoff_probe_kernel on the resident launch's grid
    (blocks, smem) at (1, 608): T x n_phases empty phases joined by the
    handoff, and by the barrier kernel's grid barrier. Its time is the chain
    floor of a resident launch; the counters must end at T x blocks (the
    handoff) and the barrier's generation at T x n_phases."""
    out = {"blocks": blocks, "smem_bytes": smem, "phases": n_phases,
           "frames": T}
    for mode in ("handoff", "barrier"):
        ctr = ar_mod.handoff_probe(n_phases, T, mode, blocks, smem, dev)
        torch.cuda.synchronize()
        c = ctr.cpu().tolist()
        ok = (c[2:] == [T * blocks] * n_phases if mode == "handoff"
              else c[:2] == [0, T * n_phases])
        if not ok:
            raise AssertionError(f"handoff probe {mode}: counters {c}")
        ms = cuda_ms(lambda: ar_mod.handoff_probe(n_phases, T, mode, blocks,
                                                  smem, dev))
        out[f"{mode}_ms"] = ms
        out[f"{mode}_us_each"] = ms * 1e3 / (T * n_phases)
    log({"phase": "handoff_probe", "card": power, **out})
    return out


# the masked BiLSTMs of the benchmark cells at batch 16, (B, T, H, input):
# a frame-level DAP's (~870 frames), the text encoder's (160 tokens), the
# context's (435 frame pairs)
LSTM_SHAPES = [(16, 870, 128, 256), (16, 160, 256, 512),
               (16, 435, 520, 1044)]


def lstm_inputs(shape, dev, seed):
    """(MaskedLSTM, x, lengths) of one bidirectional layer at a cell's
    width: a converged spectral norm (else the recurrence is chaotic),
    seeded inputs, ragged lengths with T, 1 and T / 2 among them."""
    from radtts_tpu_torch.ops.lstm import MaskedLSTM

    B, T, H, C = shape
    torch.manual_seed(seed)
    mod = MaskedLSTM(C, H, norm="spectral").to(dev).eval()
    mod.requires_grad_(False)
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(B, T, C, generator=gen)
    lens = torch.randint(1, T + 1, (B,), generator=gen)
    lens[:3] = torch.tensor([T, 1, T // 2])
    return mod, x.to(dev), lens.to(dev)


def lstm_kernel_ms(fn, calls=5):
    """The device ms of csrc/lstm.cu's kernel a call of fn, under a
    CUDA-only profiler over `calls` calls (as the split AR route's)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(getattr(e, "device_time_total", 0) for e in prof.key_averages()
               if "lstm_resident_kernel" in e.key) / calls / 1e3


def phase_lstm_kernel(lstm_mod, ar_mod, dev, power):
    """csrc/lstm.cu's persistent kernel, the route MaskedLSTM takes at every
    LSTM_SHAPES entry (asserted: one launch a run), against lstm_plain on
    the card within 1e-4 * max|plain| (fp32 sums in another order over a
    recurrence, as ar_scan's limit), exact zeros past each length; the
    layer's time (the input projection and the launch; the kernel's own
    device time from a profile) beside the cuDNN packed path on the same
    inputs ("before", held against plain too; three syncs a run), the
    plain version's, the bound (2 sum(len_b) 4H H D FLOP at 67 TFLOP/s:
    the steps the lengths ask for, no padded step) and the chain floor
    (the handoff probe on the kernel's grid, one handoff a step, x T)."""
    rows = []
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for shape in LSTM_SHAPES:
        B, T, H, C = shape
        mod, x, lens = lstm_inputs(shape, dev, seed=T)
        weights = mod.weights()
        plan = lstm_mod.lstm_plan(H, B, 2, sms)
        with torch.no_grad():
            if mod.route(x) != "kernel":
                raise AssertionError(f"lstm {shape}: route {mod.route(x)}")
            n0 = lstm_mod.lstm_cuda.launches
            got = mod(x, lens)
            torch.cuda.synchronize()
            if lstm_mod.lstm_cuda.launches != n0 + 1:
                raise AssertionError(f"lstm {shape}: not one launch")
            want = lstm_mod.lstm_plain(x, lens, weights, True)
            before = mod.packed(x, lens)
            past = torch.arange(T, device=dev)[None, :] >= lens[:, None]
            scale = want.abs().max().item()
            row = {"shape": list(shape), "blocks": plan["blocks"],
                   "units_a_block": plan["units"],
                   "smem_bytes": plan["smem"],
                   "max_abs_plain": scale,
                   "max_abs_err": (got - want).abs().max().item(),
                   "before_max_abs_err": (before - want).abs().max().item(),
                   "zeros_past_lengths": bool((got[past] == 0).all())}
            row["ms"] = cuda_ms(lambda: mod(x, lens))
            row["before_ms"] = cuda_ms(lambda: mod.packed(x, lens))
            row["plain_ms"] = cuda_ms(
                lambda: lstm_mod.lstm_plain(x, lens, weights, True),
                reps=3, warmup=1)
            row["kernel_ms"] = lstm_kernel_ms(lambda: mod(x, lens))
        flop = 2.0 * lens.sum().item() * 4 * H * H * 2
        row["bound_ms"] = flop / FP32_FLOPS * 1e3
        ar_mod.handoff_probe(1, T, "handoff", plan["blocks"], plan["smem"],
                             dev)
        row["chain_floor_ms"] = cuda_ms(lambda: ar_mod.handoff_probe(
            1, T, "handoff", plan["blocks"], plan["smem"], dev))
        row["us_per_step"] = 1e3 * row["kernel_ms"] / T
        log({"phase": "lstm_kernel_vs_plain", "card": power, **row})
        if not (row["max_abs_err"] <= 1e-4 * scale
                and row["before_max_abs_err"] <= 1e-4 * scale
                and row["zeros_past_lengths"] and scale > 0.05):
            raise AssertionError(f"lstm kernel at {shape}: {row}")
        rows.append(row)
    return rows


def gap_parts(kind, dev):
    """config_ljs_<kind>.json's model at its published widths, random from
    seed 0, folded, with the WN end convs drawn at sd 0.002 (as the
    flagship's) and every zero-initialised last layer of the f0 and
    energy flows drawn at sd 0.02."""
    from radtts_tpu_torch.models.radtts import RADTTS

    with open(GAP_CONFIGS[kind]) as f:
        config = json.load(f)
    torch.manual_seed(0)
    model = RADTTS(config["model_config"]).eval().requires_grad_(False)
    with torch.no_grad():
        for flow in model.flows:
            torch.nn.init.normal_(flow.affine.pred.end.weight, std=0.002)
        for mod in (model.f0_pred_module, model.energy_pred_module):
            lasts = ([t.pred.last for k, t in enumerate(mod.transforms)
                      if not mod.is_spline(k)]
                     if kind == "bgap" else
                     [s.spline_flow.pred.last for s in mod.flows])
            for last in lasts:
                torch.nn.init.normal_(last.weight, std=0.02)
                torch.nn.init.normal_(last.bias, std=0.02)
    return config, model.to(dev)


def phase_serve_gap(kind, vocoder, denoiser, tp, mods, dev, power):
    """A Synthesizer of gap_parts(kind) with HiFi-GAN v1 answers one
    request (TEXTS[1], sigma_f0 = sigma_energy = 0.8), its launches
    counted from 0: ar_scan 2 for AGAP (2 AR flows, f0's and energy's steps
    paired in one launch each), 0 for
    BGAP, mrf_tc 72 (one generator call). Then the 608-frame flagship
    utterance runs with stage times (durations; attributes alone, AGAP's
    f0 and energy paired as radtts_infer pairs them;
    attributes + decode; vocoder + denoiser; medians of 3) and the RTF,
    and f0, energy and mel on the card against the CPU plain path from
    the same z_f0, z_energy, residual and a seeded voiced mask: within
    1e-3 (f0 relative to its max, in Hz)."""
    from radtts_tpu_torch.models.attributes import (agap_infer_multi,
                                                    attribute_model_infer)
    from radtts_tpu_torch.models.hifigan import denoiser_apply
    from radtts_tpu_torch.models.radtts import (apply_voice_mask_to_text,
                                                encode_speaker, encode_text,
                                                infer_durations,
                                                radtts_infer)
    from radtts_tpu_torch.ops.length_regulator import regulate_length
    from radtts_tpu_torch.synthesizer import Synthesizer

    config, model = gap_parts(kind, dev)
    dc = config["data_config"]
    synth = Synthesizer.from_parts(
        config["model_config"], model, vocoder, denoiser,
        encode_fn=tp.encode_text, speaker_id_fn=lambda name: 0,
        sampling_rate=dc["sampling_rate"], hop_length=dc["hop_length"],
        seed=0, device=dev)
    _reset_counts(*mods)
    wavs, aux = synth.synthesize(TEXTS[1], "ljs", sigma_f0=0.8,
                                 sigma_energy=0.8)
    torch.cuda.synchronize()
    launches = _counts(*mods)
    if not np.isfinite(wavs[0]).all() or not np.isfinite(aux["f0"]).all():
        raise AssertionError(f"{kind}: non-finite request output")
    text, dur = flagship_input(synth)
    text, dur = text.to(dev), dur.to(dev)
    spk = torch.zeros(1, dtype=torch.int64, device=dev)
    meta = model.meta
    g, n_mel = meta["n_group_size"], meta["n_mel_channels"]
    n_ch = 2 if meta["use_first_order_features"] else 1
    gen = torch.Generator().manual_seed(5)
    z_f0 = (torch.randn(1, MAX_FRAMES, n_ch, generator=gen) * 0.8).to(dev)
    z_e = (torch.randn(1, MAX_FRAMES, n_ch, generator=gen) * 0.8).to(dev)
    res = (torch.randn(1, MAX_FRAMES // g, n_mel * g, generator=gen)
           * 0.8).to(dev)
    # a seeded voicing (70% voiced): the random voicing predictor may mark
    # every frame unvoiced, and f0 is then 0 on both sides
    vm = (torch.rand(1, MAX_FRAMES, generator=gen) < 0.7).float().to(dev)

    def durations():
        return infer_durations(model, spk, text)

    def attributes():
        txt_enc, _ = encode_text(model, text, None)
        x = regulate_length(txt_enc, dur, MAX_FRAMES)
        spk_vec = encode_speaker(model, spk)
        vm = (torch.sigmoid(attribute_model_infer(
            model.v_pred_module, x, spk_vec, dur.sum(1))[..., 0]) > 0.5
              ).float()
        x = apply_voice_mask_to_text(model, x, vm)
        if kind == "agap":     # as radtts_infer: the two in lock step
            return agap_infer_multi(
                [model.f0_pred_module, model.energy_pred_module],
                [z_f0, z_e], [x, x], [spk_vec, spk_vec], dur.sum(1))
        return [attribute_model_infer(m, x, spk_vec, dur.sum(1), z=z)
                for m, z in ((model.f0_pred_module, z_f0),
                             (model.energy_pred_module, z_e))]

    def decode():
        return radtts_infer(model, spk, text, 0.8, MAX_FRAMES, dur=dur,
                            residual=res, z_f0=z_f0, z_energy=z_e,
                            voiced_mask=vm)

    with torch.inference_mode():
        out, t_dec = timed(decode)
        audio, t_voc = timed(lambda: denoiser_apply(
            denoiser, vocoder(out["mel"]), strength=0.0))
        stage = {"durations": [], "attributes": [], "decode": [],
                 "vocoder_denoiser": []}
        for _ in range(3):
            stage["durations"].append(timed(durations)[1])
            stage["attributes"].append(timed(attributes)[1])
            stage["decode"].append(timed(decode)[1])
            stage["vocoder_denoiser"].append(timed(lambda: denoiser_apply(
                denoiser, vocoder(out["mel"]), strength=0.0))[1])
        med = {k: statistics.median(v) for k, v in stage.items()}
        seconds = MAX_FRAMES * dc["hop_length"] / dc["sampling_rate"]
        rtf = (med["durations"] + med["decode"]
               + med["vocoder_denoiser"]) / 1e3 / seconds
        model.to("cpu")
        ref = radtts_infer(model, spk.cpu(), text.cpu(), 0.8, MAX_FRAMES,
                           dur=dur.cpu(), residual=res.cpu(),
                           z_f0=z_f0.cpu(), z_energy=z_e.cpu(),
                           voiced_mask=vm.cpu())
        model.to(dev)
    errs = {}
    for key in ("f0", "energy_avg", "mel"):
        errs[key] = (out[key].cpu() - ref[key]).abs().max().item()
        errs[key + "_max_abs"] = ref[key].abs().max().item()
    want_ar = 2 if kind == "agap" else 0
    log({"phase": f"serve_{kind}", "card": power, "frames": MAX_FRAMES,
         "stage_ms": med, "stage_ms_all": stage, "rtf": rtf,
         "first_decode_ms": t_dec, "first_vocoder_ms": t_voc,
         "launches": launches, "card_vs_cpu": errs,
         "request_samples": int(wavs[0].size),
         "voiced_frames": int(out["voiced_mask"].sum())})
    if (launches["ar_scan"] != want_ar or launches["mrf_tc"] != 72
            or launches["lstm"] != GAP_CALL_LSTMS
            or launches["mas"] or launches["mel"] or launches["mrf_stack"]
            or launches["mrf_conv"] or launches["mas_block"]
            or launches["ar_scan_barrier"] or launches["mrf_tc_one_pass"]
            or launches["mrf_tf32"]):
        raise AssertionError(f"serve_{kind} launches {launches}")
    if not (errs["f0_max_abs"] > 0 and
            errs["f0"] <= 1e-3 * errs["f0_max_abs"]
            and errs["energy_avg"] <= 1e-3 and errs["mel"] <= 1e-3):
        raise AssertionError(f"serve_{kind} card vs CPU: {errs}")
    if not torch.isfinite(audio).all():
        raise AssertionError(f"serve_{kind}: non-finite audio")
    return launches


def phase_train_gap(mods, dev, power, root, files, dec_ckpt, voc, voc_cfg,
                    text):
    """python -m radtts_tpu_torch.train's main on config_ljs_bgap.json and
    config_ljs_agap.json as published (unfreeze_modules durf0energyvpred,
    batch 16, binarize and KL from step 0), each warm-started from the
    decoder checkpoint the RADTTS training phase wrote, 2 steps each with
    a validation and a checkpoint at step 0; then each checkpoint serves
    one text through python -m radtts_tpu_torch.inference's main. Counted
    from 0 before the first run and read after the last training run
    (mas: 2 binarized steps and 1 validation batch a run; ar_scan 0), the
    serving apart (ar_scan 2 for AGAP's text, 0 for BGAP's)."""
    from radtts_tpu_torch.inference import main as inference_main
    from radtts_tpu_torch.train import main as train_main

    configs = {}
    for kind, path in GAP_CONFIGS.items():
        with open(path) as f:
            config = json.load(f)
        config["data_config"].update(
            files, betabinom_cache_path=os.path.join(root, "cache"))
        configs[kind] = os.path.join(root, f"{kind}.json")
        with open(configs[kind], "w") as f:
            json.dump(config, f)
    runs = {}
    _reset_counts(*mods)
    for kind in GAP_CONFIGS:
        runs[kind] = train_main([
            "-c", configs[kind], "-p",
            f"train_config.output_directory={root}/{kind}_out",
            "train_config.epochs=2", "train_config.seed=0",
            "train_config.batch_size=16",
            f"train_config.warmstart_checkpoint_path={dec_ckpt}"])
    launches = _counts(*mods)
    serve = {}
    for kind in GAP_CONFIGS:
        _reset_counts(*mods)
        tic = time.perf_counter()
        written = inference_main([
            "-c", configs[kind], "-r", f"{root}/{kind}_out/model_0",
            "-v", voc, "-k", voc_cfg, "-t", text, "-s", "ljs", "-o",
            os.path.join(root, f"{kind}_wavs"), "--seed", "0",
            "--sigma_f0", "0.8", "--sigma_energy", "0.8"])
        serve[kind] = {"seconds": time.perf_counter() - tic,
                       "launches": _counts(*mods),
                       "samples": int(_check_wav(written[0],
                                                 written[0]).size)}
    history = [dict(h, run=k) for k, hs in runs.items() for h in hs]
    for h in history:
        vals = [v for v in h.values() if isinstance(v, float)]
        if not all(np.isfinite(vals)):
            raise AssertionError(f"non-finite step {h}")
    log({"phase": "train_gap", "card": power,
         "steps": [{k: h[k] for k in ("run", "iteration", "ms", "total",
                                      "grad_norm", "loss_f0",
                                      "loss_energy", "loss_mel")}
                   for h in history],
         "step_ms": {k: [h["ms"] for h in hs] for k, hs in runs.items()},
         "validation": {k: [h["validation"] for h in hs
                            if "validation" in h]
                        for k, hs in runs.items()},
         "launches": launches, "serve": serve})
    if (any(len(hs) != 2 for hs in runs.values())
            or launches != {"mas": 6, "mel": 0, "mrf_tc": 0,
                            "mrf_tc_one_pass": 0, "mrf_tf32": 0,
                            "mrf_stack": 0,
                            "mrf_conv": 0, "ar_scan": 0,
                            "mas_block": 0, "ar_scan_barrier": 0,
                            "lstm": 14}
            or serve["agap"]["launches"]["ar_scan"] != 2
            or serve["bgap"]["launches"]["ar_scan"] != 0
            or any(v["launches"]["lstm"] != GAP_CALL_LSTMS
                   for v in serve.values())
            or any(v["launches"]["ar_scan_barrier"]
                   or v["launches"]["mas_block"]
                   or v["launches"]["mrf_tc_one_pass"]
                   or v["launches"]["mrf_tf32"]
                   for v in serve.values())
            or any(v["launches"]["mrf_tc"] != 2 * 72
                   for v in serve.values())):
        raise AssertionError(f"train_gap: steps "
                             f"{[len(h) for h in runs.values()]}"
                             f", launches {launches}, serving {serve}")
    total = {k: launches[k] + sum(v["launches"][k] for v in serve.values())
             for k in launches}
    return {"train_gap": launches, "serve_gap_files": {
        k: sum(v["launches"][k] for v in serve.values()) for k in launches},
        "total": total}


BGAP_CONV_FRAMES = 192     # the batch-2 check's frames, before grouping
CONV_WAYS = ("cudnn_port_layout", "cudnn_contiguous", "native")


def _simple_conv_cudnn(enabled):
    """SimpleConvNet.forward with its convolutions on cuDNN (enabled) or
    off it whatever the grad mode, to time the two and hold them against
    each other (undo with the returned function)."""
    from radtts_tpu_torch.models.coupling import SimpleConvNet

    chosen = SimpleConvNet.forward

    def forward(self, x, mask=None, use_partial_padding=True):
        c = torch.backends.cudnn
        with c.flags(enabled=enabled, benchmark=c.benchmark,
                     deterministic=c.deterministic, allow_tf32=c.allow_tf32):
            for layer in self.layers:
                x = torch.relu(layer(x, mask, use_partial_padding))
            return self.last(x)

    SimpleConvNet.forward = forward
    return lambda: setattr(SimpleConvNet, "forward", chosen)


def _conv_way(way, x, w, b, padding, dilation):
    """One conv (B, T, C_in) -> (B, T, C_out) the way named: cuDNN on the
    port's layout (ops/conv.py:conv1d hands F.conv1d a (B, C, T) view of
    the (B, T, C) tensor), cuDNN on a contiguous (B, C, T) copy, or
    PyTorch's own convolution (cuDNN off)."""
    from radtts_tpu_torch.ops.conv import conv1d

    c = torch.backends.cudnn
    with c.flags(enabled=way != "native", benchmark=c.benchmark,
                 deterministic=c.deterministic, allow_tf32=c.allow_tf32):
        if way == "cudnn_contiguous":
            return F.conv1d(x.transpose(1, 2).contiguous(), w, b,
                            padding=padding,
                            dilation=dilation).transpose(1, 2)
        return conv1d(x, w, b, padding, dilation)


def phase_simple_conv_cudnn(dev, power):
    """Why SimpleConvNet runs its convolutions outside cuDNN, and what
    that costs. Each distinct conv of config_ljs_bgap.json's
    SimpleConvNets (f0 and energy, batch 2 at BGAP_CONV_FRAMES over the
    group size, the model's seeded weights) runs forward and backward (y,
    dx, dw, db from a seeded upstream gradient) in fp32 each of CONV_WAYS,
    each held against float64 (max abs error over max abs), with the
    kernels cuDNN ran (torch.profiler) and each way's forward + backward
    ms. Then the BGAP's serving attributes stage (f0 and energy at 608
    frames, medians of 5) and a training step at RADTTS_STEP (decoder
    frozen, medians of steps 2-4) with the SimpleConvNets off and on
    cuDNN, each also once under the profiler (device busy ms, top
    kernels); then _kink_sensitivity. Fails if a conv is further than 1e-5 of
    max from float64."""
    from torch.profiler import ProfilerActivity, profile

    from radtts_tpu_torch.models.attributes import attribute_model_infer
    from radtts_tpu_torch.models.radtts import (apply_voice_mask_to_text,
                                                encode_speaker, encode_text)
    from radtts_tpu_torch.ops.length_regulator import regulate_length
    from radtts_tpu_torch.train.trainer import batch_to_device, train_step

    config, model = gap_parts("bgap", dev)
    mc, tc = config["model_config"], config["train_config"]
    gen = torch.Generator().manual_seed(9)
    rows, seen = [], set()
    for attr in ("f0", "energy"):
        mod = getattr(model, f"{attr}_pred_module")
        T = BGAP_CONV_FRAMES // mod.n_group_size
        for k, tr in enumerate(mod.transforms):
            for li, layer in enumerate([*tr.pred.layers, tr.pred.last]):
                w = layer.effective_weight().detach()
                key = (tuple(w.shape), layer.dilation)
                if key in seen:
                    continue
                seen.add(key)
                c_out, c_in, ks = w.shape
                x = torch.randn(2, T, c_in, generator=gen)
                if li:
                    x = torch.relu(x)
                gy = torch.randn(2, T, c_out, generator=gen).to(dev)
                x = x.to(dev)
                b = layer.bias.detach()

                def fwd_bwd(way, dtype=torch.float32):
                    xs, ws, bs = (t.to(dtype).requires_grad_(True)
                                  for t in (x, w, b))
                    y = _conv_way(way, xs, ws, bs, layer.padding,
                                  layer.dilation)
                    return (y, *torch.autograd.grad(y, (xs, ws, bs),
                                                    gy.to(dtype)))

                ref = fwd_bwd("native", torch.float64)
                row = {"attr": attr, "transform": k, "layer": li,
                       "c_in": c_in, "c_out": c_out, "kernel_size": ks,
                       "dilation": layer.dilation, "frames": T}
                for way in CONV_WAYS:
                    got = fwd_bwd(way)
                    row[way] = {name: ((g.double() - r).abs().max()
                                       / r.abs().max()).item()
                                for name, g, r in zip(("y", "dx", "dw",
                                                       "db"), got, ref)}
                    row[way]["ms"] = cuda_ms(lambda: fwd_bwd(way), reps=5,
                                             warmup=1)
                    if way != "native":
                        with profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA]) \
                                as prof:
                            fwd_bwd(way)
                            torch.cuda.synchronize()
                        row[way]["kernels"] = sorted({
                            e.key[:110] for e in prof.key_averages()
                            if e.device_type
                            == torch.autograd.DeviceType.CUDA})
                rows.append(row)
    log({"phase": "simple_conv_cudnn_layers", "card": power,
         "batch": 2, "rows": rows})
    worst = max(r[way][k] for r in rows for way in CONV_WAYS
                for k in ("y", "dx", "dw", "db"))
    if not worst <= 1e-5:
        raise AssertionError(f"a SimpleConvNet conv {worst} of max from "
                             "float64")

    text = torch.from_numpy(np.random.default_rng(3).integers(
        1, 180, (1, 90))).to(dev)
    dur = torch.full((1, 90), MAX_FRAMES // 90, dtype=torch.int64,
                     device=dev)
    dur[0, -1] += MAX_FRAMES - int(dur.sum())
    spk = torch.zeros(1, dtype=torch.int64, device=dev)
    n_ch = 2 if model.meta["use_first_order_features"] else 1
    z = torch.randn(2, 1, MAX_FRAMES, n_ch, generator=gen).to(dev) * 0.8

    def attributes():
        txt_enc, _ = encode_text(model, text, None)
        x = regulate_length(txt_enc, dur, MAX_FRAMES)
        spk_vec = encode_speaker(model, spk)
        vm = (torch.sigmoid(attribute_model_infer(
            model.v_pred_module, x, spk_vec, dur.sum(1))[..., 0]) > 0.5
              ).float()
        x = apply_voice_mask_to_text(model, x, vm)
        return [attribute_model_infer(m, x, spk_vec, dur.sum(1), z=zi)
                for m, zi in zip((model.f0_pred_module,
                                  model.energy_pred_module), z)]

    t_model, trainable, opt = _radtts_trainer(mc, dev, seed=1,
                                              unfreeze="durf0energyvpred")
    batch = batch_to_device(radtts_step_batch(
        *RADTTS_STEP, mc["n_mel_channels"], 2), dev)

    def step():
        total, _, _ = train_step(t_model, opt, trainable, batch, mc,
                                 tc["loss_weights"], 1.0, True, True,
                                 tc["grad_clip_val"])
        return float(total)

    def synced(fn):
        def run():
            fn()
            torch.cuda.synchronize()
        return run

    result = {}
    for name in ("native", "cudnn"):
        undo = _simple_conv_cudnn(name == "cudnn")
        try:
            with torch.inference_mode():
                stage = [timed(attributes)[1] for _ in range(6)][1:]
                stage_prof = profile_run(synced(attributes), top=6)
            steps = [timed(step)[1] for _ in range(4)]
            step_prof = profile_run(synced(step), top=6)
        finally:
            undo()
        result[name] = {
            "attributes_ms": statistics.median(stage),
            "attributes_ms_all": stage,
            "attributes_device_busy_ms": stage_prof["device_busy_ms"],
            "attributes_top_kernels": stage_prof["top_kernels"],
            "step_ms": statistics.median(steps[1:]), "step_ms_all": steps,
            "step_device_busy_ms": step_prof["device_busy_ms"],
            "step_top_kernels": step_prof["top_kernels"]}
    log({"phase": "simple_conv_cudnn_cost", "card": power,
         "frames": MAX_FRAMES, "step_batch": list(RADTTS_STEP), **result})
    del t_model, trainable, opt, model
    kinks = _kink_sensitivity(mc, dev)
    log({"phase": "simple_conv_kink_sensitivity", "card": power, **kinks})
    return rows, result, kinks


KINK_NOISE = (1e-7, 2.5e-7, 1e-6, 2e-6)


def _kink_sensitivity(mc, dev):
    """How far fp32-sized rounding in the SimpleConvNets moves the BGAP's
    gradients. config_ljs_bgap.json's energy model alone (training form,
    seeded, its zero-initialised last layers drawn at sd 0.02) in float64
    on the card, at the batch-2 check's (2, BGAP_CONV_FRAMES) with lengths
    192 and 150 and seeded inputs: the gradients of its flow NLL with
    every SimpleConvNet conv output given additive noise of sd
    eps * max|y| / 4 on the valid frames (about what a conv whose max
    error is eps * max|y| adds), for each eps of KINK_NOISE, held against
    the noiseless gradients by phase_radtts_vs_cpu's distance; with the
    count of relu inputs on valid frames whose sign the noise flipped.
    Without a flip the gradients move in proportion to eps; a flip at a
    kink moves them by a step of its own."""
    from radtts_tpu_torch.losses import attribute_prediction_loss
    from radtts_tpu_torch.models.attributes import (attribute_model,
                                                    attribute_model_forward)
    from radtts_tpu_torch.models.coupling import SimpleConvNet
    from radtts_tpu_torch.models.radtts import attribute_config

    cfg = attribute_config(mc["energy_model_config"],
                           mc["use_first_order_features"])
    torch.manual_seed(0)
    model = attribute_model(cfg, n_speaker_dim=mc["n_speaker_dim"],
                            factored=True)
    with torch.no_grad():
        for k, tr in enumerate(model.transforms):
            if not model.is_spline(k):
                torch.nn.init.normal_(tr.pred.last.weight, std=0.02)
                torch.nn.init.normal_(tr.pred.last.bias, std=0.02)
    model = model.double().to(dev)
    gen = torch.Generator().manual_seed(21)
    B, T = 2, BGAP_CONV_FRAMES
    n_in = cfg["hparams"]["n_in_dim"]
    txt = torch.randn(B, T, mc["n_text_dim"], generator=gen)
    spk = torch.randn(B, mc["n_speaker_dim"], generator=gen)
    x = torch.randn(B, T, n_in, generator=gen) * 0.5
    txt, spk, x = (t.double().to(dev) for t in (txt, spk, x))
    lens = torch.tensor([T, 150], device=dev)
    g = cfg["hparams"]["n_group_size"]
    chosen = SimpleConvNet.forward
    state = {}

    def forward(self, x, mask=None, use_partial_padding=True):
        for layer in [*self.layers, self.last]:
            y = layer(x, mask, use_partial_padding)
            valid = (torch.ones_like(y) if mask is None
                     else mask.to(y.dtype)[:, :, None].expand_as(y))
            if state["eps"]:
                y = y + torch.randn(y.shape, generator=state["gen"],
                                    dtype=y.dtype, device=y.device) * (
                    state["eps"] * y.detach().abs().max() / 4) * valid
            if layer is self.last:
                return y
            state["signs"].append((y.detach() > 0)[valid > 0])
            x = torch.relu(y)

    def grads(eps):
        state.update(eps=eps, signs=[],
                     gen=torch.Generator(dev).manual_seed(5))
        model.zero_grad()
        out = attribute_model_forward(model, txt, spk, x, lens)
        loss = attribute_prediction_loss("energy", out, lens, 1.0, g)
        loss["loss_energy"][0].backward()
        return ([p.grad.clone() for p in model.parameters()],
                state["signs"])

    SimpleConvNet.forward = forward
    try:
        ref, signs0 = grads(0.0)
        floor = 1e-3 * torch.stack([r.norm() for r in ref]).norm()
        names = [k for k, _ in model.named_parameters()]
        rows = []
        for eps in KINK_NOISE:
            got, signs = grads(eps)
            dist = [((a - r).norm() / torch.maximum(r.norm(), floor)).item()
                    for a, r in zip(got, ref)]
            worst = max(range(len(dist)), key=dist.__getitem__)
            rows.append({"eps": eps, "worst_tensor": names[worst],
                         "worst_distance": dist[worst],
                         "tensors_over_1e-3": sum(d > 1e-3 for d in dist),
                         "median_distance": statistics.median(dist),
                         "relu_sign_flips": int(sum(
                             (a != b).sum() for a, b in zip(signs, signs0)))})
    finally:
        SimpleConvNet.forward = chosen
    return {"batch": [B, T], "lens": [T, 150], "tensors": len(ref),
            "rows": rows}


# ---------------------------------------------------------------------------
# voice conversion, mixed precision, and generators off the hand kernels
# ---------------------------------------------------------------------------

# HiFi-GAN V3: jik876/hifi-gan config_v3.json (ResBlock2)
HIFIGAN_V3 = {
    "resblock": "2",
    "upsample_rates": [8, 8, 4],
    "upsample_kernel_sizes": [16, 16, 8],
    "upsample_initial_channel": 256,
    "resblock_kernel_sizes": [3, 5, 7],
    "resblock_dilation_sizes": [[1, 2], [2, 6], [3, 12]],
}
# ResBlock1 at V2's widths with dilations the hand kernels do not take
HIFIGAN_RB1_DILATIONS = dict(HIFIGAN_V2,
                             resblock_dilation_sizes=[[1, 2, 4]] * 3)
VC_SAMPLES = 2             # -n of the voice-conversion CLI runs
# masked LSTM runs a synthesis call, each on the LSTM kernel: the text
# encoder twice (durations, decode), the context and the duration DAP, and
# for config_ljs_dap.json the f0 and energy DAPs
DAP_CALL_LSTMS, GAP_CALL_LSTMS = 6, 4
AMP_VARIANTS = {"fp32": {}, "amp": {"use_amp": True},
                "bf16_weights": {"weight_dtype": "bfloat16"},
                "amp_bf16_weights": {"use_amp": True,
                                     "weight_dtype": "bfloat16"}}


GL_FFT, GL_HOP, GL_ITERS = 1024, 256, 30   # griffin_lim's defaults
GL_RTOL = 1e-2      # card against CPU, of max|CPU|


def phase_griffin_lim(mods, dev, power):
    """ops/stft.py:griffin_lim (plain PyTorch, called by no path) on the
    card: the magnitudes (1, 608, 513) of a seeded two-sine-plus-noise
    signal of the flagship length, n_fft 1024, hop 256, 30 rounds, from
    one initial phase drawn on the CPU and given to the card and to the
    CPU. The card's waveform must lie within GL_RTOL * max of the CPU's:
    the phase of a bin whose magnitude is near 0 is ill-conditioned, so
    30 rounds amplify fp32 differences between two FFTs well past one
    round's rounding (tests/test_torch_griffin_lim.py: 1e-7 of max at 0
    rounds, up to 7.2e-6 at 4, at a small shape). Each run's distance
    from the CPU's float64 run is logged beside it. ms: median of 10
    synchronized runs on the host clock after 2 warm-ups; then one run
    under the profiler. Launches no hand kernel (counted)."""
    from radtts_tpu_torch.ops.stft import griffin_lim, stft_magnitude_phase

    n = GL_HOP * (MAX_FRAMES - 1)
    rng = np.random.default_rng(11)
    t = np.arange(n) / 22050
    sig = torch.from_numpy((0.4 * np.sin(2 * np.pi * 220 * t)
                            + 0.2 * np.sin(2 * np.pi * 1330 * t)
                            + 0.05 * rng.standard_normal(n))[None]
                           .astype(np.float32))
    mag, _ = stft_magnitude_phase(sig, GL_FFT, GL_HOP, GL_FFT)
    phase0 = (torch.rand(mag.shape, generator=torch.Generator()
                         .manual_seed(12)) * (2 * np.pi) - np.pi)
    cpu = griffin_lim(mag, GL_ITERS, GL_FFT, GL_HOP, GL_FFT, phase0=phase0)
    f64 = griffin_lim(mag.double(), GL_ITERS, GL_FFT, GL_HOP, GL_FFT,
                      phase0=phase0.double())
    mag_d, phase0_d = mag.to(dev), phase0.to(dev)

    def run():
        return griffin_lim(mag_d, GL_ITERS, GL_FFT, GL_HOP, GL_FFT,
                           phase0=phase0_d)

    before = _counts(*mods)
    for _ in range(2):
        card, _ = timed(run)
    times = [timed(run)[1] for _ in range(10)]
    profile = profile_run(lambda: (run(), torch.cuda.synchronize()))
    launches = {k: v - before[k] for k, v in _counts(*mods).items()}
    card = card.cpu()
    scale = float(cpu.abs().max())
    err = float((card - cpu).abs().max()) / scale
    card_f64 = float((card.double() - f64).abs().max()) / scale
    cpu_f64 = float((cpu.double() - f64).abs().max()) / scale
    log({"phase": "griffin_lim", "nvidia_smi": power,
         "shape": list(mag.shape), "n_fft": GL_FFT, "hop": GL_HOP,
         "n_iters": GL_ITERS, "out_shape": list(card.shape),
         "ms": statistics.median(times), "ms_runs": times,
         "max_abs_err_rel_cpu": err, "card_from_float64": card_f64,
         "cpu_from_float64": cpu_f64, "launches": launches,
         "profile": profile})
    if tuple(card.shape) != (1, n) or not torch.isfinite(card).all():
        raise AssertionError(f"griffin_lim: {tuple(card.shape)}, finite "
                             f"{bool(torch.isfinite(card).all())}")
    if err > GL_RTOL:
        raise AssertionError(f"griffin_lim: card {err:.3g} of max from "
                             f"the CPU (limit {GL_RTOL})")
    if any(launches.values()):
        raise AssertionError(f"griffin_lim launched hand kernels: "
                             f"{launches}")


def _audible(gen, gain=3.0, seed=2):
    """A random generator made audible: conv_pre, the ups and conv_post
    scaled by gain and their biases drawn at sd 0.05 (normal(0, 0.01)
    weights give a v1 waveform of scale 1e-4; gain 3, one of ~0.1)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in [gen.conv_pre, *gen.ups, gen.conv_post]:
            m.weight.mul_(gain)
            m.bias.copy_(0.05 * torch.randn(m.bias.shape, generator=g))
    return gen


def phase_vc(mods, dev, power, root, dap_ckpt, dap_config):
    """python -m radtts_tpu_torch.inference_voice_conversion's main on the
    card, on the DAP checkpoint and the seeded validation wavs the RADTTS
    training phase wrote (config_ljs_dap.json's widths; its WN end convs,
    zero at init and barely moved by 4 steps, drawn at sd 0.002 as the
    serving phase's are, or the decode at --sigma 0 gives a constant
    mel), with HiFi-GAN v1 (seeded, made audible): -n VC_SAMPLES at
    --sigma 0, with the
    utterances' own f0 and energy injected, then with --predict_features.
    Counted from 0 before each run: mas once per utterance (the
    binarized forward), mrf_tc 72 per vocoder call (the denoiser's at
    load, then one per utterance), the others 0. Each wav 22.05 kHz,
    finite, not silent. Then, per utterance, the durations on the card
    against the CPU's (the number of tokens apart is reported; the CPU
    decodes from the card's), the card's mels against the CPU's decode
    (max-abs 1e-3, the DAP serving limit), the first wav against the CPU
    vocoder and denoiser on the card's mel (1e-3 * max), and the wall ms
    of each utterance on the card (forward, decode, vocoder, denoiser)."""
    from radtts_tpu_torch import inference_voice_conversion as vc
    from radtts_tpu_torch.data.dataset import Data, DataCollate, DataLoader
    from radtts_tpu_torch.models.hifigan import (Generator, denoiser_apply,
                                                 generator_to_reference)
    from radtts_tpu_torch.models.radtts import radtts_forward, radtts_infer
    from radtts_tpu_torch.train.checkpoint import load_radtts_for_inference
    from radtts_tpu_torch.vocoder_io import load_vocoder

    ckpt = torch.load(dap_ckpt, map_location="cpu", weights_only=True)
    gen = torch.Generator().manual_seed(11)
    ends = [k for k in ckpt["model"] if k.startswith("flows.")
            and k.endswith(".affine.pred.end.weight")]
    for k in ends:
        ckpt["model"][k] = 0.002 * torch.randn(ckpt["model"][k].shape,
                                               generator=gen)
    if not ends:
        raise AssertionError("vc: no WN end conv in the DAP checkpoint")
    dap_ckpt = os.path.join(root, "vc_model")
    torch.save(ckpt, dap_ckpt)
    torch.manual_seed(7)
    voc = os.path.join(root, "vc_hifigan.pt")
    torch.save({"generator": generator_to_reference(
        _audible(Generator(HIFIGAN_V1)))}, voc)
    voc_cfg = os.path.join(root, "vc_hifigan.json")
    with open(voc_cfg, "w") as f:
        json.dump(HIFIGAN_V1, f)
    modes = {"injected": [], "predicted": ["--predict_features"]}
    runs = {}
    for mode, extra in modes.items():
        out_dir = os.path.join(root, f"vc_{mode}")
        _reset_counts(*mods)
        tic = time.perf_counter()
        written = vc.main([
            "-r", dap_ckpt, "-c", dap_config, "-v", voc, "-k", voc_cfg,
            "-o", out_dir, "-n", str(VC_SAMPLES), "--sigma", "0",
            "--seed", "0", "--save_mels", "--save_features", *extra])
        seconds = time.perf_counter() - tic
        launches = _counts(*mods)
        wavs = [_check_wav(p, p) for p in written]
        want = {"mas": VC_SAMPLES, "mel": 0,
                "mrf_tc": 72 * (VC_SAMPLES + 1),
                "mrf_tc_one_pass": 0, "mrf_tf32": 0,
                "mrf_stack": 0,
                "mrf_conv": 0, "ar_scan": 0,
                "mas_block": 0, "ar_scan_barrier": 0,
                "lstm": {"injected": 14, "predicted": 18}[mode]}
        if len(written) != VC_SAMPLES or launches != want:
            raise AssertionError(f"vc {mode}: {len(written)} wavs, "
                                 f"launches {launches} != {want}")
        runs[mode] = {"dir": out_dir, "seconds": seconds,
                      "launches": launches, "written": written,
                      "samples": [int(w.size) for w in wavs],
                      "max_abs": [float(np.abs(w).max()) for w in wavs]}

    # the same utterances at the function level, card against CPU
    with open(dap_config) as f:
        config = json.load(f)
    mc, dc = config["model_config"], dict(config["data_config"])
    model_dev = load_radtts_for_inference(dap_ckpt, mc)[0].to(dev)
    model_cpu = load_radtts_for_inference(dap_ckpt, mc)[0]
    vocoder, denoiser = load_vocoder(voc, voc_cfg, device=dev)
    voc_cpu, den_cpu = load_vocoder(voc, voc_cfg, device="cpu")
    ignore = ("training_files", "validation_files")
    trainset = Data(dc["training_files"],
                    **{k: v for k, v in dc.items() if k not in ignore})
    dc["dur_max"] = 60
    valset = Data(dc["validation_files"],
                  **{k: v for k, v in dc.items() if k not in ignore},
                  speaker_ids=trainset.speaker_ids)
    loader = DataLoader(valset, 1, DataCollate(), shuffle=False, seed=0,
                        num_workers=1, drop_last=False)
    g = mc["n_group_size"]
    rows = []
    with torch.inference_mode():
        for k, batch in enumerate(loader):
            if k == VC_SAMPLES:
                break
            name = os.path.splitext(os.path.basename(
                batch["audiopaths"][0]))[0]
            stem = f"{name}_0_sid{int(batch['speaker_ids'][0])}_sigma0.0"

            def forward(model, device):
                b = {key: torch.as_tensor(np.asarray(batch[key]),
                                          device=device)
                     for key in ("mel", "speaker_ids", "text",
                                 "input_lengths", "output_lengths",
                                 "attn_prior", "f0", "energy_avg",
                                 "voiced_mask", "p_voiced")}
                out = radtts_forward(
                    model, b["mel"], b["speaker_ids"], b["text"],
                    b["input_lengths"], b["output_lengths"],
                    binarize_attention_flag=True, attn_prior=b["attn_prior"],
                    f0=b["f0"], energy_avg=b["energy_avg"],
                    voiced_mask=b["voiced_mask"], p_voiced=b["p_voiced"])
                dur = torch.floor(out["attn"][0].sum(0) + 0.5)
                return dur.to(torch.int32)[None], b

            def decode(model, device, dur, b, mode):
                total = int(dur.sum())
                T = vc._frame_budget(total, g)
                kw = {} if mode == "predicted" else dict(
                    f0=vc._frames(batch["f0"], T, device),
                    energy_avg=vc._frames(batch["energy_avg"], T, device),
                    voiced_mask=vc._frames(batch["voiced_mask"], T, device))
                out = radtts_infer(model, b["speaker_ids"], b["text"], 0.0,
                                   T, dur=dur, sigma_f0=1.0,
                                   sigma_energy=1.0, **kw)
                return out["mel"][:, :total]

            def on_card():
                dur, b = forward(model_dev, dev)
                mel = decode(model_dev, dev, dur, b, "injected")
                audio = denoiser_apply(denoiser, vocoder(mel), 0.01)
                return dur, audio
            (dur_dev, _), ms = timed(on_card)
            dur_cpu, b_cpu = forward(model_cpu, "cpu")
            n_diff = int((dur_dev.cpu() != dur_cpu).sum())
            row = {"utterance": name, "tokens": int(dur_cpu.shape[1]),
                   "frames": int(dur_dev.sum()), "wall_ms": ms,
                   "durations_differ": n_diff}
            for mode in modes:
                mel_dev = np.load(os.path.join(runs[mode]["dir"],
                                               stem + "_mel.npy"))
                mel_cpu = decode(model_cpu, "cpu", dur_dev.cpu(), b_cpu,
                                 mode).numpy().transpose(0, 2, 1)
                if mel_dev.shape != mel_cpu.shape:
                    raise AssertionError(f"vc {mode} {name}: mel "
                                         f"{mel_dev.shape} vs "
                                         f"{mel_cpu.shape}")
                row[f"{mode}_mel_max_abs_err"] = float(
                    np.abs(mel_dev - mel_cpu).max())
                row[f"{mode}_mel_max_abs"] = float(np.abs(mel_cpu).max())
                if k == 0:
                    from scipy.io import wavfile
                    wav_dev = wavfile.read(os.path.join(
                        runs[mode]["dir"], stem + ".wav"))[1]
                    wav_cpu = denoiser_apply(den_cpu, voc_cpu(torch.as_tensor(
                        mel_dev.transpose(0, 2, 1))), 0.01)[0].numpy()
                    row[f"{mode}_wav_max_abs_err"] = float(
                        np.abs(wav_dev - wav_cpu).max())
                    row[f"{mode}_wav_max_abs"] = float(
                        np.abs(wav_cpu).max())
            rows.append(row)
    loader.close()
    log({"phase": "vc", "card": power,
         "runs": {m: {k: v for k, v in r.items()
                      if k not in ("dir", "written")}
                  for m, r in runs.items()},
         "utterances": rows})
    for row in rows:
        for mode in modes:
            if not row[f"{mode}_mel_max_abs_err"] <= 1e-3:
                raise AssertionError(f"vc {mode} mel on the card vs CPU: "
                                     f"{row}")
            key = f"{mode}_wav_max_abs_err"
            if key in row and not row[key] <= 1e-3 * row[
                    f"{mode}_wav_max_abs"]:
                raise AssertionError(f"vc {mode} vocoder on the card vs "
                                     f"CPU: {row}")
    return {k: sum(r["launches"][k] for r in runs.values())
            for k in runs["injected"]["launches"]}


def _region_dtypes(model, fn):
    """fn() with hooks on the model's bf16 regions (ops/amp.py): the
    dtypes leaving each region module, and those of the convs, LSTMs and
    dense layers inside one (the context LSTM is the RADTTS region)."""
    from radtts_tpu_torch.ops import amp
    from radtts_tpu_torch.ops.conv import ConvNorm
    from radtts_tpu_torch.ops.lstm import MaskedLSTM

    leaving, inside, hooks = set(), set(), []
    regions = [m for m in amp.regions(model) if m is not model]
    for r in regions:
        hooks.append(r.register_forward_hook(
            lambda mod, inp, out: leaving.add(str(out.dtype))))
        for m in r.modules():
            if m is not r and isinstance(m, (ConvNorm, MaskedLSTM,
                                             torch.nn.Linear)):
                hooks.append(m.register_forward_hook(
                    lambda mod, inp, out: inside.add(str(out.dtype))))
    if model.context_lstm is not None:
        hooks.append(model.context_lstm.register_forward_hook(
            lambda mod, inp, out: inside.add(str(out.dtype))))
    try:
        fn()
    finally:
        for h in hooks:
            h.remove()
    return sorted(leaving), sorted(inside)


def phase_amp_serve(config, model, vocoder, denoiser, tp, mods, dev, power):
    """The flagship Synthesizer with use_amp=True, weight_dtype="bfloat16"
    and both, beside fp32, on the 608-frame utterance (fixed durations,
    a seeded residual): each variant's mel distance from the card's fp32
    mel, beside the CPU's own distance on the same weights (the card's at
    most 3x the CPU's, or 1e-3); the dtype leaving each bf16 region
    (fp32) and inside it (bf16); the stage times and the RTF (median of
    3), a profiled AMP utterance (which LSTM kernels ran); the resident
    conv-kernel bytes fp32 and bf16. One request a variant through
    synthesize; counted from 0 before the first: mrf_tc 72 per vocoder
    call, the others 0."""
    from radtts_tpu_torch.models.hifigan import denoiser_apply
    from radtts_tpu_torch.models.radtts import infer_durations, radtts_infer
    from radtts_tpu_torch.ops import amp
    from radtts_tpu_torch.ops.fold_norms import (conv_weight_bytes,
                                                 store_conv_weights)
    from radtts_tpu_torch.synthesizer import Synthesizer

    mc, dc = config["model_config"], config["data_config"]
    synths = {name: Synthesizer.from_parts(
        mc, model, vocoder, denoiser, encode_fn=tp.encode_text,
        speaker_id_fn=lambda name: 0, sampling_rate=dc["sampling_rate"],
        hop_length=dc["hop_length"], seed=0, device=dev, **kw)
        for name, kw in AMP_VARIANTS.items()}
    text, dur = flagship_input(synths["fp32"])
    g = mc["n_group_size"]
    res = torch.randn(1, MAX_FRAMES // g, mc["n_mel_channels"] * g,
                      generator=torch.Generator().manual_seed(3)) * 0.8
    spk = torch.zeros(1, dtype=torch.int64)
    model_cpu = copy.deepcopy(model).cpu()
    cpu_models = {"fp32": model_cpu,
                  "bf16": store_conv_weights(copy.deepcopy(model_cpu))}

    def decode(m, use_amp, device):
        with amp.scope(m, use_amp):
            return radtts_infer(m, spk.to(device), text.to(device), 0.8,
                                MAX_FRAMES, dur=dur.to(device),
                                residual=res.to(device))["mel"]

    hop = synths["fp32"].hop_length
    audio_s = MAX_FRAMES * hop / synths["fp32"].sampling_rate
    rows, card_fp32, cpu_fp32 = {}, None, None
    _reset_counts(*mods)
    n_calls = 0
    with torch.inference_mode():
        for name, s in synths.items():
            wavs, aux = s.synthesize(TEXTS[1], "ljs")
            n_calls += 1
            if not np.isfinite(wavs[0]).all() or wavs[0].shape != (
                    int(aux["n_frames"][0]) * hop,):
                raise AssertionError(f"amp serve {name}: bad request")
            mel = decode(s.model, s.use_amp, dev)
            cpu = decode(cpu_models["bf16" if s.weight_dtype == "bfloat16"
                                    else "fp32"], s.use_amp, "cpu")
            if name == "fp32":
                card_fp32, cpu_fp32 = mel, cpu
            text_d, dur_d = text.to(dev), dur.to(dev)
            spk_d = spk.to(dev)

            def utterance():
                with amp.scope(s.model, s.use_amp):
                    _, t_dur = timed(lambda: infer_durations(
                        s.model, spk_d, text_d))
                    out, t_dec = timed(lambda: radtts_infer(
                        s.model, spk_d, text_d, 0.8, MAX_FRAMES, dur=dur_d,
                        generator=s.generator))
                audio, t_voc = timed(lambda: denoiser_apply(
                    s.denoiser, s.vocoder(out["mel"]), strength=0.01))
                return audio, {"durations": t_dur, "decode": t_dec,
                               "vocoder_denoiser": t_voc}
            times = [utterance()[1] for _ in range(3)]
            n_calls += 3
            med = {k: statistics.median(t[k] for t in times)
                   for k in times[0]}
            rows[name] = {
                "stage_ms": med, "rtf": sum(med.values()) / 1e3 / audio_s,
                "mel_dist_from_fp32_card": float(
                    (mel - card_fp32).abs().max()),
                "mel_dist_from_fp32_cpu": float(
                    (cpu - cpu_fp32).abs().max()),
                "mel_card_vs_cpu": float((mel.cpu() - cpu).abs().max()),
                "conv_weight_bytes": conv_weight_bytes(s.model),
                "parameter_bytes": sum(p.numel() * p.element_size()
                                       for p in s.model.parameters())}
            if s.use_amp:
                leaving, inside = _region_dtypes(
                    s.model, lambda: decode(s.model, True, dev))
                rows[name].update(region_out_dtypes=leaving,
                                  region_inside_dtypes=inside)
                if leaving != ["torch.float32"] or inside != [
                        "torch.bfloat16"]:
                    raise AssertionError(f"amp serve {name}: regions "
                                         f"leave {leaving}, run {inside}")
        profile = profile_run(lambda: timed(
            lambda: decode(synths["amp"].model, True, dev)), top=20)
        n_lstm = [k for k in profile["top_kernels"]
                  if any(t in k["name"].lower() for t in ("rnn", "lstm"))]
    launches = _counts(*mods)
    log({"phase": "amp_serve_608", "card": power, "audio_s": audio_s,
         "variants": rows, "launches": launches,
         "generator_calls": n_calls, "amp_decode_profile": profile,
         "amp_lstm_kernels": n_lstm})
    if launches != {"mas": 0, "mel": 0, "mrf_tc": 72 * n_calls,
                    "mrf_tc_one_pass": 0, "mrf_tf32": 0,
                    "mrf_stack": 0, "mrf_conv": 0, "ar_scan": 0,
                    "mas_block": 0, "ar_scan_barrier": 0,
                    # fp32 and bf16 weights: every run (a request, the
                    # decode, 3 utterances); under AMP the text encoder
                    # alone (outside every bf16 region), there and in the
                    # profiled decode and the two region probes
                    "lstm": (2 * (DAP_CALL_LSTMS + 4 + 3 * DAP_CALL_LSTMS)
                             + 2 * (2 + 1 + 3 * 2) + 1 + 2)}:
        raise AssertionError(f"amp serve launches {launches}, "
                             f"{n_calls} generator calls")
    for name, row in rows.items():
        if name == "fp32":
            continue
        card, cpu = (row["mel_dist_from_fp32_card"],
                     row["mel_dist_from_fp32_cpu"])
        if not (card > 0 and card <= max(3 * cpu, 1e-3)):
            raise AssertionError(f"amp serve {name}: the card's distance "
                                 f"from fp32 {card}, the CPU's {cpu}")
    if not rows["bf16_weights"]["conv_weight_bytes"] < \
            rows["fp32"]["conv_weight_bytes"]:
        raise AssertionError("bf16 weights: conv bytes did not fall")
    return launches


def phase_amp_train(mods, dev, power, root, files, dec_ckpt):
    """python -m radtts_tpu_torch.train's main on config_ljs_dap.json as
    published (use_amp true, unfreeze_modules durf0energyvpred), its data
    files repointed at the seeded dataset, batch 16 (the dataset holds
    16 wavs), warm-started from the decoder checkpoint: 2 steps, then 2
    more with train_config.optim_state_dtype bfloat16. Per run: step ms,
    peak memory, the optimizer state's bytes and dtypes from the
    checkpoint at step 0, finite losses; counted from 0 before the first
    run: mas 3 a run (2 binarized steps, 1 validation batch)."""
    from radtts_tpu_torch.train import main as train_main

    with open(CONFIG) as f:
        config = json.load(f)
    config["data_config"].update(
        files, betabinom_cache_path=os.path.join(root, "cache"))
    variants = {"amp": "", "amp_bf16_moments": "bfloat16"}
    rows = {}
    _reset_counts(*mods)
    for name, state_dtype in variants.items():
        config["train_config"]["optim_state_dtype"] = state_dtype
        path = os.path.join(root, f"{name}.json")
        with open(path, "w") as f:
            json.dump(config, f)
        out = os.path.join(root, f"{name}_out")
        torch.cuda.reset_peak_memory_stats()
        hist = train_main([
            "-c", path, "-p", f"train_config.output_directory={out}",
            "train_config.epochs=2", "train_config.seed=0",
            "train_config.batch_size=16",
            f"train_config.warmstart_checkpoint_path={dec_ckpt}"])
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        state = torch.load(os.path.join(out, "model_0"), map_location="cpu",
                           weights_only=True)["optimizer"]["state"]
        moments = [t for st in state.values() for k, t in st.items()
                   if k.startswith("exp_avg")]
        for h in hist:
            if not all(np.isfinite(v) for v in h.values()
                       if isinstance(v, float)):
                raise AssertionError(f"amp train {name}: {h}")
        rows[name] = {
            "step_ms": [h["ms"] for h in hist],
            "losses": [{k: h[k] for k in ("iteration", "total", "grad_norm",
                                          "loss_f0", "loss_energy",
                                          "loss_duration", "loss_vpred")}
                       for h in hist],
            "peak_allocated_gib": peak,
            "optimizer_state_bytes": sum(t.numel() * t.element_size()
                                         for t in moments),
            "optimizer_state_dtypes": sorted({str(t.dtype)
                                              for t in moments})}
    launches = _counts(*mods)
    log({"phase": "amp_train", "card": power, "runs": rows,
         "launches": launches})
    want_dtypes = {"amp": ["torch.float32"],
                   "amp_bf16_moments": ["torch.bfloat16"]}
    if (any(len(r["step_ms"]) != 2 for r in rows.values())
            or any(rows[k]["optimizer_state_dtypes"] != v
                   for k, v in want_dtypes.items())
            or launches != {"mas": 6, "mel": 0, "mrf_tc": 0,
                            "mrf_tc_one_pass": 0, "mrf_tf32": 0,
                            "mrf_stack": 0,
                            "mrf_conv": 0, "ar_scan": 0,
                            "mas_block": 0, "ar_scan_barrier": 0,
                            "lstm": 14}):
        raise AssertionError(f"amp train: {rows}, launches {launches}")
    return launches


def phase_resblock2(mods, dev, power):
    """Generators the hand kernels do not take, run as chains of cuDNN
    convs as the JAX package runs them through XLA: HiFi-GAN V3 (ResBlock2
    at config_v3.json's widths) and a ResBlock1 at V2's widths with
    dilations (1, 2, 4); seeded, made audible, on a seeded 608-frame mel.
    Counted from 0: no hand-kernel launch. The waveform within 1e-3 * max
    of the CPU; vocoder ms (median of 3 after a warm-up)."""
    from radtts_tpu_torch.models.hifigan import Generator

    rows = {}
    _reset_counts(*mods)
    for name, h in (("v3_resblock2", HIFIGAN_V3),
                    ("v2_resblock1_dilations", HIFIGAN_RB1_DILATIONS)):
        torch.manual_seed(9)
        gen = _audible(Generator(h)).eval().requires_grad_(False)
        mel = 2.0 * torch.randn(1, MAX_FRAMES, 80,
                                generator=torch.Generator().manual_seed(6)
                                ) - 5.0
        with torch.inference_mode():
            wav_cpu = gen(mel)
            gen.to(dev)
            mel_dev = mel.to(dev)
            runs = [timed(lambda: gen(mel_dev)) for _ in range(4)]
        wav = runs[-1][0]
        if gen.mrf_kernels or wav.shape != (1, MAX_FRAMES * 256) or \
                not torch.isfinite(wav).all():
            raise AssertionError(f"{name}: bad audio {tuple(wav.shape)}")
        err = (wav.cpu() - wav_cpu).abs().max().item()
        scale = wav_cpu.abs().max().item()
        ms = [t for _, t in runs[1:]]
        rows[name] = {"vocoder_ms": ms,
                      "vocoder_ms_median": statistics.median(ms),
                      "wav_max_abs_err": err, "wav_max_abs": scale}
        if not err <= 1e-3 * scale:
            raise AssertionError(f"{name} on the card vs CPU: {err}")
        del gen
    launches = _counts(*mods)
    log({"phase": "resblock2_608", "card": power, "generators": rows,
         "launches": launches})
    if any(launches.values()):
        raise AssertionError(f"resblock2: hand kernels launched {launches}")
    return launches


# ---------------------------------------------------------------------------
# model options and trainer features: the FFTransformer DAPs, the plain-W
# decoder, bf16 weights with an AGAP, the validation's audio samples and
# the profiler window
# ---------------------------------------------------------------------------

FFT_DAPS = ("dur_model_config", "f0_model_config", "energy_model_config")
AUDIO_TAGS = ["decoder_sample_gt_attributes"] + [
    f"sample_attribute_sigma_{s}" for s in (0.1, 0.5, 0.8, 1.0)]


def dap_variant_config(kind):
    """config_ljs_dap.json with one model option set through update_params,
    as -p sets it: "fft", the duration, f0 and energy DAPs on the
    FFTransformer (use_transformer true; the duration DAP's config holds
    no such key, so it is added as false first, since -p sets only keys
    a config holds); "plain_w", the decoder's 1x1s with a plain W
    (matrix_decomposition "")."""
    from radtts_tpu_torch.config import update_params

    with open(CONFIG) as f:
        config = json.load(f)
    if kind == "fft":
        for key in FFT_DAPS:
            config["model_config"][key]["hparams"].setdefault(
                "use_transformer", False)
        update_params(config, [f"model_config.{key}.hparams."
                               "use_transformer=True" for key in FFT_DAPS])
    else:
        update_params(config, ['model_config.matrix_decomposition=""'])
    return config


def _dap_attributes(model, text, dur, spk):
    """The attributes stage of a DAP model on the card: the voicing DAP,
    then the f0 and energy DAPs (as radtts_infer runs them)."""
    from radtts_tpu_torch.models.attributes import attribute_model_infer
    from radtts_tpu_torch.models.radtts import (apply_voice_mask_to_text,
                                                encode_speaker, encode_text)
    from radtts_tpu_torch.ops.length_regulator import regulate_length

    txt_enc, _ = encode_text(model, text, None)
    x = regulate_length(txt_enc, dur, MAX_FRAMES)
    spk_vec = encode_speaker(model, spk)
    lens = dur.sum(1)
    vm = (torch.sigmoid(attribute_model_infer(
        model.v_pred_module, x, spk_vec, lens)[..., 0]) > 0.5).float()
    x = apply_voice_mask_to_text(model, x, vm)
    return [attribute_model_infer(m, x, spk_vec, lens)
            for m in (model.f0_pred_module, model.energy_pred_module)]


def phase_serve_dap_variant(kind, vocoder, denoiser, tp, mods, dev, power,
                            convlstm_model=None):
    """dap_variant_config(kind)'s model at its published widths, random
    from seed 0 (the WN end convs at sd 0.002), with HiFi-GAN v1: one
    request (TEXTS[1]) counted from 0 (mrf_tc 72, the others 0); the
    608-frame utterance with stage times (durations, attributes alone,
    attributes + decode, vocoder + denoiser; medians of 3) and the RTF,
    with the ConvLSTM DAP model's attributes stage (convlstm_model, the
    flagship) timed beside in the same call; then the decode from a
    seeded residual on the card against the CPU (within 1e-3) and the
    vocoder of the card's mel against the CPU's (within 1e-3 * max)."""
    from radtts_tpu_torch.models.hifigan import denoiser_apply
    from radtts_tpu_torch.models.radtts import (RADTTS, infer_durations,
                                                radtts_infer)
    from radtts_tpu_torch.synthesizer import Synthesizer

    config = dap_variant_config(kind)
    mc, dc = config["model_config"], config["data_config"]
    torch.manual_seed(0)
    model = RADTTS(mc).eval().requires_grad_(False)
    with torch.no_grad():
        for flow in model.flows:
            torch.nn.init.normal_(flow.affine.pred.end.weight, std=0.002)
    synth = Synthesizer.from_parts(
        mc, model, vocoder, denoiser, encode_fn=tp.encode_text,
        speaker_id_fn=lambda name: 0, sampling_rate=dc["sampling_rate"],
        hop_length=dc["hop_length"], seed=0, device=dev)
    _reset_counts(*mods)
    wavs, aux = synth.synthesize(TEXTS[1], "ljs")
    torch.cuda.synchronize()
    launches = _counts(*mods)
    if not np.isfinite(wavs[0]).all() or wavs[0].shape != (
            int(aux["n_frames"][0]) * dc["hop_length"],):
        raise AssertionError(f"serve_{kind}: bad request output")
    text, dur = (t.to(dev) for t in flagship_input(synth))
    spk = torch.zeros(1, dtype=torch.int64, device=dev)
    g, n_mel = mc["n_group_size"], mc["n_mel_channels"]
    res = torch.randn(1, MAX_FRAMES // g, n_mel * g,
                      generator=torch.Generator().manual_seed(3)) * 0.8

    def decode():
        return radtts_infer(model, spk, text, 0.8, MAX_FRAMES, dur=dur,
                            residual=res.to(dev))

    with torch.inference_mode():
        out, _ = timed(decode)
        stage = {"durations": [], "attributes": [], "decode": [],
                 "vocoder_denoiser": []}
        convlstm_ms = []
        for _ in range(3):
            stage["durations"].append(timed(
                lambda: infer_durations(model, spk, text))[1])
            stage["attributes"].append(timed(
                lambda: _dap_attributes(model, text, dur, spk))[1])
            if convlstm_model is not None:
                convlstm_ms.append(timed(lambda: _dap_attributes(
                    convlstm_model, text, dur, spk))[1])
            stage["decode"].append(timed(decode)[1])
            stage["vocoder_denoiser"].append(timed(lambda: denoiser_apply(
                denoiser, vocoder(out["mel"]), strength=0.0))[1])
        wav = vocoder(out["mel"])
        med = {k: statistics.median(v) for k, v in stage.items()}
        seconds = MAX_FRAMES * dc["hop_length"] / dc["sampling_rate"]
        rtf = (med["durations"] + med["decode"]
               + med["vocoder_denoiser"]) / 1e3 / seconds
        model.to("cpu")
        ref = radtts_infer(model, spk.cpu(), text.cpu(), 0.8, MAX_FRAMES,
                           dur=dur.cpu(), residual=res)["mel"]
        model.to(dev)
        wav_cpu = vocoder.to("cpu")(out["mel"].cpu())
        vocoder.to(dev)
    errs = {"mel": (out["mel"].cpu() - ref).abs().max().item(),
            "mel_max_abs": ref.abs().max().item(),
            "wav": (wav.cpu() - wav_cpu).abs().max().item(),
            "wav_max_abs": wav_cpu.abs().max().item()}
    row = {"phase": f"serve_{kind}", "card": power, "frames": MAX_FRAMES,
           "stage_ms": med, "stage_ms_all": stage, "rtf": rtf,
           "launches": launches, "card_vs_cpu": errs,
           "request_samples": int(wavs[0].size)}
    if convlstm_model is not None:
        row["convlstm_attributes_ms"] = statistics.median(convlstm_ms)
        row["convlstm_attributes_ms_all"] = convlstm_ms
    log(row)
    if launches != {"mas": 0, "mel": 0, "mrf_tc": 72,
                    "mrf_tc_one_pass": 0, "mrf_tf32": 0,
                    "mrf_stack": 0,
                    "mrf_conv": 0, "ar_scan": 0, "mas_block": 0,
                    "ar_scan_barrier": 0,
                    # the FFTransformer's DAPs run no LSTM
                    "lstm": {"fft": 3, "plain_w": DAP_CALL_LSTMS}[kind]}:
        raise AssertionError(f"serve_{kind} launches {launches}")
    if not (errs["mel"] <= 1e-3 and errs["wav"] <= 1e-3 * errs["wav_max_abs"]
            and torch.isfinite(out["mel"]).all()):
        raise AssertionError(f"serve_{kind} card vs CPU: {errs}")
    return launches


def phase_serve_agap_bf16(vocoder, denoiser, tp, mods, dev, power):
    """gap_parts("agap") served with weight_dtype="bfloat16" beside fp32:
    one bf16 request counted from 0 (ar_scan 2: f0's and energy's flows
    paired, mrf_tc 72); the 608-frame utterance from seeded z_f0,
    z_energy, residual and voiced mask: the bf16 mel's distance from the
    card's fp32 mel at most 3x the CPU's own bf16-to-fp32 distance (or
    1e-3), f0 and energy beside; the stage times and the RTF (medians of
    3); the resident conv-kernel bytes fp32 and bf16."""
    from radtts_tpu_torch.models.hifigan import denoiser_apply
    from radtts_tpu_torch.models.radtts import infer_durations, radtts_infer
    from radtts_tpu_torch.ops.fold_norms import (conv_weight_bytes,
                                                 store_conv_weights)
    from radtts_tpu_torch.synthesizer import Synthesizer

    config, model = gap_parts("agap", dev)
    mc, dc = config["model_config"], config["data_config"]
    synths = {w: Synthesizer.from_parts(
        mc, model, vocoder, denoiser, encode_fn=tp.encode_text,
        speaker_id_fn=lambda name: 0, sampling_rate=dc["sampling_rate"],
        hop_length=dc["hop_length"], seed=0, device=dev, weight_dtype=w)
        for w in ("float32", "bfloat16")}
    _reset_counts(*mods)
    wavs, aux = synths["bfloat16"].synthesize(TEXTS[1], "ljs",
                                              sigma_f0=0.8, sigma_energy=0.8)
    torch.cuda.synchronize()
    launches = _counts(*mods)
    if not np.isfinite(wavs[0]).all() or not np.isfinite(aux["f0"]).all():
        raise AssertionError("serve_agap_bf16: non-finite request output")
    text, dur = flagship_input(synths["float32"])
    spk = torch.zeros(1, dtype=torch.int64)
    g, n_mel = mc["n_group_size"], mc["n_mel_channels"]
    gen = torch.Generator().manual_seed(5)
    z_f0 = torch.randn(1, MAX_FRAMES, 1, generator=gen) * 0.8
    z_e = torch.randn(1, MAX_FRAMES, 1, generator=gen) * 0.8
    res = torch.randn(1, MAX_FRAMES // g, n_mel * g, generator=gen) * 0.8
    vm = (torch.rand(1, MAX_FRAMES, generator=gen) < 0.7).float()

    def decode(m, device):
        return radtts_infer(
            m, spk.to(device), text.to(device), 0.8, MAX_FRAMES,
            dur=dur.to(device), residual=res.to(device),
            z_f0=z_f0.to(device), z_energy=z_e.to(device),
            voiced_mask=vm.to(device))

    model_cpu = copy.deepcopy(model).cpu()
    cpu_models = {"float32": model_cpu,
                  "bfloat16": store_conv_weights(copy.deepcopy(model_cpu))}
    outs, rows = {}, {}
    seconds = MAX_FRAMES * dc["hop_length"] / dc["sampling_rate"]
    with torch.inference_mode():
        for w, s in synths.items():
            outs[w] = (decode(s.model, dev), decode(cpu_models[w], "cpu"))
            text_d, dur_d, spk_d = text.to(dev), dur.to(dev), spk.to(dev)
            stage = {"durations": [], "decode": [], "vocoder_denoiser": []}
            for _ in range(3):
                stage["durations"].append(timed(lambda: infer_durations(
                    s.model, spk_d, text_d))[1])
                o, t_dec = timed(lambda: radtts_infer(
                    s.model, spk_d, text_d, 0.8, MAX_FRAMES, dur=dur_d,
                    generator=s.generator))
                stage["decode"].append(t_dec)
                stage["vocoder_denoiser"].append(timed(lambda: denoiser_apply(
                    s.denoiser, s.vocoder(o["mel"]), strength=0.0))[1])
            med = {k: statistics.median(v) for k, v in stage.items()}
            rows[w] = {"stage_ms": med,
                       "rtf": sum(med.values()) / 1e3 / seconds,
                       "conv_weight_bytes": conv_weight_bytes(s.model)}

    def dist(a, b, key):
        return (a[key].cpu() - b[key].cpu()).abs().max().item()

    for key in ("mel", "f0", "energy_avg"):
        rows["bfloat16"][key + "_dist_from_fp32_card"] = dist(
            outs["bfloat16"][0], outs["float32"][0], key)
        rows["bfloat16"][key + "_dist_from_fp32_cpu"] = dist(
            outs["bfloat16"][1], outs["float32"][1], key)
        rows["bfloat16"][key + "_card_vs_cpu"] = dist(
            outs["bfloat16"][0], outs["bfloat16"][1], key)
    rows["float32"]["f0_max_abs"] = outs["float32"][1]["f0"].abs().max(
    ).item()
    log({"phase": "serve_agap_bf16", "card": power, "frames": MAX_FRAMES,
         "variants": rows, "launches": launches})
    card = rows["bfloat16"]["mel_dist_from_fp32_card"]
    cpu = rows["bfloat16"]["mel_dist_from_fp32_cpu"]
    if launches != {"mas": 0, "mel": 0, "mrf_tc": 72,
                    "mrf_tc_one_pass": 0, "mrf_tf32": 0,
                    "mrf_stack": 0,
                    "mrf_conv": 0, "ar_scan": 2, "mas_block": 0,
                    "ar_scan_barrier": 0, "lstm": GAP_CALL_LSTMS}:
        raise AssertionError(f"serve_agap_bf16 launches {launches}")
    if not (card > 0 and card <= max(3 * cpu, 1e-3)):
        raise AssertionError(f"serve_agap_bf16: the card's mel distance "
                             f"from fp32 {card}, the CPU's {cpu}")
    if not (rows["bfloat16"]["conv_weight_bytes"]
            < rows["float32"]["conv_weight_bytes"]):
        raise AssertionError("serve_agap_bf16: conv bytes did not fall")
    return launches


def _write_config(config, root, name, files):
    config["data_config"].update(
        files, betabinom_cache_path=os.path.join(root, "cache"))
    path = os.path.join(root, f"{name}.json")
    with open(path, "w") as f:
        json.dump(config, f)
    return path


def phase_train_fft(mods, dev, power, root, files, dec_ckpt, voc, voc_cfg,
                    text):
    """python -m radtts_tpu_torch.train's main on dap_variant_config("fft")
    (use_amp true and unfreeze_modules durf0energyvpred as published,
    so the FFTransformer DAPs train with their dropout on; batch 16)
    warm-started from the decoder checkpoint, 2 steps with a validation
    and a checkpoint at step 0, counted from 0 (mas 3: 2 binarized steps
    and 1 validation batch); one text served from its checkpoint through
    python -m radtts_tpu_torch.inference (mrf_tc 144, mas 0); then one
    step at batch 2 on the card against the CPU with dropout off
    (phase_radtts_vs_cpu's rule)."""
    from radtts_tpu_torch.inference import main as inference_main
    from radtts_tpu_torch.train import main as train_main

    path = _write_config(dap_variant_config("fft"), root, "fft", files)
    _reset_counts(*mods)
    history = train_main([
        "-c", path, "-p", f"train_config.output_directory={root}/fft_out",
        "train_config.epochs=2", "train_config.seed=0",
        "train_config.batch_size=16",
        f"train_config.warmstart_checkpoint_path={dec_ckpt}"])
    launches = _counts(*mods)
    _reset_counts(*mods)
    tic = time.perf_counter()
    written = inference_main([
        "-c", path, "-r", f"{root}/fft_out/model_0", "-v", voc, "-k",
        voc_cfg, "-t", text, "-s", "ljs", "-o",
        os.path.join(root, "fft_wavs"), "--seed", "0"])
    serve = {"seconds": time.perf_counter() - tic,
             "launches": _counts(*mods),
             "samples": int(_check_wav(written[0], written[0]).size)}
    for h in history:
        vals = [v for v in h.values() if isinstance(v, float)]
        if not all(np.isfinite(vals)):
            raise AssertionError(f"train_fft: non-finite step {h}")
    log({"phase": "train_fft", "card": power,
         "steps": [{k: h[k] for k in ("iteration", "ms", "total",
                                      "grad_norm", "loss_duration",
                                      "loss_f0", "loss_energy")
                    if k in h} for h in history],
         "validation": [h["validation"] for h in history
                        if "validation" in h],
         "launches": launches, "serve": serve})
    if (len(history) != 2
            or launches != {"mas": 3, "mel": 0, "mrf_tc": 0,
                            "mrf_tc_one_pass": 0, "mrf_tf32": 0,
                            "mrf_stack": 0,
                            "mrf_conv": 0, "ar_scan": 0, "mas_block": 0,
                            "ar_scan_barrier": 0,
                            "lstm": 4}
            or serve["launches"]["mrf_tc"] != 2 * 72
            or serve["launches"]["lstm"] != 3
            or serve["launches"]["mas"]
            or serve["launches"]["mrf_tc_one_pass"]
            or serve["launches"]["mrf_tf32"]):
        raise AssertionError(f"train_fft: {len(history)} steps, launches "
                             f"{launches}, serving {serve}")
    phase_radtts_vs_cpu(dev, config_path=path, unfreeze="durf0energyvpred",
                        phase="fft_train_step_card_vs_cpu")
    return {"train_fft": launches, "serve_fft_files": serve["launches"]}


def phase_train_plain_w(mods, dev, power, root, files):
    """python -m radtts_tpu_torch.train's main on dap_variant_config(
    "plain_w") from random weights, every module trainable (so the plain
    W trains, its log-determinant by slogdet), use_amp false, batch 16:
    2 steps with a validation at step 0, counted from 0 (mas 3); the
    checkpoint's 8 plain Ws finite."""
    from radtts_tpu_torch.train import main as train_main

    path = _write_config(dap_variant_config("plain_w"), root, "plain_w",
                         files)
    _reset_counts(*mods)
    history = train_main([
        "-c", path, "-p", f"train_config.output_directory={root}/pw_out",
        "train_config.epochs=2", "train_config.seed=0",
        "train_config.batch_size=16", "train_config.use_amp=false",
        "train_config.unfreeze_modules=all",
        "train_config.warmstart_checkpoint_path="])
    launches = _counts(*mods)
    state = torch.load(f"{root}/pw_out/model_0", map_location="cpu",
                       weights_only=True)["model"]
    w_keys = [k for k in state if k.endswith(".inv.w1x1")]
    for h in history:
        vals = [v for v in h.values() if isinstance(v, float)]
        if not all(np.isfinite(vals)):
            raise AssertionError(f"train_plain_w: non-finite step {h}")
    log({"phase": "train_plain_w", "card": power,
         "steps": [{k: h[k] for k in ("iteration", "ms", "total",
                                      "grad_norm", "loss_mel")}
                   for h in history],
         "plain_w_tensors": len(w_keys), "launches": launches})
    if (len(history) != 2 or len(w_keys) != 8
            or not all(torch.isfinite(state[k]).all() for k in w_keys)
            or launches != {"mas": 3, "mel": 0, "mrf_tc": 0,
                            "mrf_tc_one_pass": 0, "mrf_tf32": 0,
                            "mrf_stack": 0,
                            "mrf_conv": 0, "ar_scan": 0, "mas_block": 0,
                            "ar_scan_barrier": 0,
                            "lstm": 5}):
        raise AssertionError(f"train_plain_w: {len(history)} steps, "
                             f"{len(w_keys)} plain Ws, launches {launches}")
    return launches


class AudioRecorder:
    """A logger that keeps the audio the trainer's validation writes and
    drops its scalars and images."""

    def __init__(self):
        self.audio = []

    def add_audio(self, tag, audio, step, sample_rate):
        self.audio.append((tag, np.asarray(audio), step, sample_rate))

    def add_scalar(self, *args, **kwargs):
        pass

    add_image = add_scalar


def phase_train_audio_samples(mods, dev, power, root, files, dec_ckpt, voc,
                              voc_cfg):
    """python -m radtts_tpu_torch.train's main on config_ljs_dap.json as
    published (log_decoder_samples and log_attribute_samples on), its
    vocoder_checkpoint_path and vocoder_config_path naming the seeded
    HiFi-GAN v1 the port's writer put in the temporary directory, batch
    16, warm-started from the decoder checkpoint: one step and its
    validation, with profile_dir set over iteration 0, counted from 0
    (mas 2: the step, the validation batch). The trace in profile_dir
    must hold CUDA kernel events. The CLI logs (and so samples) only where
    tensorboardX imports, as the JAX trainer does: mrf_tc 6 x 72 there,
    else 0. Then the validation of the checkpoint it wrote (the trainer's
    compute_validation_loss), timed with and without the samples, into a
    recording logger: with them it must get the same five tags, counted
    from 0 (mrf_tc 6 x 72: the denoiser's bias at the vocoder's load and
    5 samples; mas 1), without them no sample (mrf_tc 0)."""
    from radtts_tpu_torch.data.dataset import DataCollate, data_factory
    from radtts_tpu_torch.train import main as train_main
    from radtts_tpu_torch.train.checkpoint import load_train_checkpoint
    from radtts_tpu_torch.train.trainer import (compute_validation_loss,
                                                init_model)

    with open(CONFIG) as f:
        config = json.load(f)
    config["train_config"].update(vocoder_checkpoint_path=voc,
                                  vocoder_config_path=voc_cfg,
                                  profile_dir="", profile_start_iter=5,
                                  profile_n_iters=5)
    path = _write_config(config, root, "samples", files)
    out, prof = os.path.join(root, "samples_out"), os.path.join(root, "prof")
    try:
        import tensorboardX  # noqa: F401
        has_tbx = True
    except ImportError:
        has_tbx = False
    _reset_counts(*mods)
    tic = time.perf_counter()
    history = train_main([
        "-c", path, "-p", f"train_config.output_directory={out}",
        "train_config.epochs=1", "train_config.seed=0",
        "train_config.batch_size=16",
        f"train_config.warmstart_checkpoint_path={dec_ckpt}",
        f"train_config.profile_dir={prof}",
        "train_config.profile_start_iter=0",
        "train_config.profile_n_iters=0"])
    cli_s = time.perf_counter() - tic
    cli_launches = _counts(*mods)
    with open(os.path.join(prof, "trace_0_0.json")) as f:
        trace = json.load(f)["traceEvents"]
    cuda_kernels = sum(e.get("cat") == "kernel" for e in trace)

    with open(path) as f:
        config = json.load(f)
    mc, dc, tc = (config["model_config"], config["data_config"],
                  config["train_config"])
    model = init_model(mc, 0, dev)
    load_train_checkpoint(f"{out}/model_0", model, None, mc)
    trainset = data_factory(dc, "training_files")
    valset = data_factory(dc, "validation_files", trainset.speaker_ids)
    val_ms, recorders, launches = {}, {}, {}
    for name, train_config in (("without_samples", None),
                               ("with_samples", tc)):
        recorders[name] = AudioRecorder()
        _reset_counts(*mods)
        _, val_ms[name] = timed(lambda: compute_validation_loss(
            model, valset, DataCollate(), 16, dev, mc, tc["loss_weights"],
            tc["sigma"], 0, recorders[name], train_config=train_config,
            sampling_rate=dc["sampling_rate"]))
        launches[name] = _counts(*mods)
    recorded = recorders["with_samples"].audio
    log({"phase": "train_audio_samples", "card": power,
         "tensorboardX": has_tbx, "cli_seconds": cli_s,
         "step_ms": [h["ms"] for h in history], "validation_ms": val_ms,
         "cli_launches": cli_launches, "validation_launches": launches,
         "recorded_audio": [{"tag": t, "sample_rate": sr,
                             "samples": int(a.size),
                             "max_abs": float(np.abs(a).max())}
                            for t, a, _, sr in recorded],
         "trace_events": len(trace), "trace_cuda_kernels": cuda_kernels})
    zero = {"mas": 0, "mel": 0, "mrf_tc": 0,
            "mrf_tc_one_pass": 0, "mrf_tf32": 0,
            "mrf_stack": 0, "mrf_conv": 0,
            "ar_scan": 0, "mas_block": 0, "ar_scan_barrier": 0, "lstm": 0}
    # the LSTM kernel: the runs that want no gradient, 18 more with the
    # samples (as the validation's with and without them)
    if (cli_launches != dict(zero, mas=2, mrf_tc=6 * 72 if has_tbx else 0,
                             lstm=6 + (18 if has_tbx else 0))
            or launches["with_samples"] != dict(zero, mas=1, mrf_tc=6 * 72,
                                                lstm=5 + 18)
            or launches["without_samples"] != dict(zero, mas=1, lstm=5)):
        raise AssertionError(f"train_audio_samples launches: CLI "
                             f"{cli_launches}, validation {launches}")
    if [t for t, _, _, _ in recorded] != AUDIO_TAGS or any(
            sr != 22050 or not np.isfinite(a).all()
            or not np.abs(a).max() > 1e-3 for _, a, _, sr in recorded):
        raise AssertionError(f"train_audio_samples: "
                             f"{[(t, sr) for t, _, _, sr in recorded]}")
    if recorders["without_samples"].audio or not cuda_kernels:
        raise AssertionError("train_audio_samples: samples without a "
                             f"train_config, or {cuda_kernels} CUDA kernel "
                             "events in the trace")
    return launches["with_samples"]


# ---------------------------------------------------------------------------
# --matmul_precision, the one-pass MRF, bf16 AGAP heads, FLOP counts,
# the data preflight
# ---------------------------------------------------------------------------

PRECISIONS = ("highest", "high", "default")


def phase_mrf_tc_one_pass(mrf_mod, dev, power, inputs):
    """csrc/mrf_tc.cu's one-TF32-pass build (route="tc", passes=1: the
    route of --matmul_precision default until csrc/mrf_tf32.cu replaced
    it) against mrf_plain(passes=1)
    on the card at
    the four v1 serving stages, within 1e-4 * max|plain| (each conv's
    operands rounded to TF32, fp32 sums in another order; a rounding
    boundary crossed between the two chains moves an operand by one TF32
    ulp), with its time beside the 3xTF32 build's on the same inputs, the
    plain version's, the cuDNN chain's at TF32 (library) and the bound at
    the TF32 rate; and both builds' distance from the fp32 plain MRF.
    Launches here are comparisons: the path's count is the precision
    sweep's."""
    from radtts_tpu_torch.ops import precision

    rows, max_err = [], 0.0
    for B, T, C in STAGES:
        x, w = inputs[(B, T, C)]
        got = mrf_mod.mrf_cuda(x, w, route="tc", passes=1)
        three = mrf_mod.mrf_cuda(x, w, passes=3)
        want = mrf_mod.mrf_plain(x, w, passes=1)
        fp32 = mrf_mod.mrf_plain(x, w)
        torch.cuda.synchronize()
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        max_err = max(max_err, err)
        xc, tw = library_inputs(x, w)
        _, _, flop, _, _ = mrf_bound(B, T, C)
        n_weights = sum(6 * (k * C * C + C) for k in (3, 7, 11))
        t_ops = flop / TF32_FLOPS
        t_bytes = 4.0 * (2 * B * T * C + n_weights) / HBM_BYTES
        with precision.scope("high"):
            library_ms = cuda_ms(lambda: library_mrf(xc, tw))
        row = {"shape": [B, T, C], "max_abs_err": err,
               "max_abs_plain": scale,
               "dist_from_fp32": (got - fp32).abs().max().item(),
               "three_pass_dist_from_fp32": (three - fp32).abs().max()
               .item(),
               "ms": cuda_ms(lambda: mrf_mod.mrf_cuda(x, w, route="tc",
                                                     passes=1)),
               "three_pass_ms": cuda_ms(
                   lambda: mrf_mod.mrf_cuda(x, w, passes=3)),
               "plain_ms": cuda_ms(
                   lambda: mrf_mod.mrf_plain(x, w, passes=1)),
               "library_ms": library_ms,
               "bound_ms": max(t_ops, t_bytes) * 1e3,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "gflop": flop / 1e9}
        row["one_over_three"] = row["ms"] / row["three_pass_ms"]
        log({"phase": "mrf_tc_one_pass_vs_plain", "card": power, **row})
        if not err <= 1e-4 * scale:
            raise AssertionError(f"mrf_tc one pass disagrees at "
                                 f"{(B, T, C)}: {err} > 1e-4 * {scale}")
        rows.append(row)
    return rows, max_err


def tf32_tiles(C):
    """csrc/mrf_tf32.cu's tile shapes (TN, NWG) at width C."""
    tns = {256: (64, 128), 128: (64, 128), 64: (32, 64), 32: (32,)}[C]
    return [(tn, nwg) for tn in tns for nwg in (1, 2)]


def tf32_bound(B, T, C, ks=(3, 7, 11)):
    """(bound ms, bound_by, FLOP) of one MRF stage in one TF32 pass: its
    FLOP at the 495 TFLOP/s TF32 rate against x and the weights read once
    and the output written once."""
    _, _, flop, _, _ = mrf_bound(B, T, C, ks)
    n_weights = sum(6 * (k * C * C + C) for k in ks)
    t_ops = flop / TF32_FLOPS
    t_bytes = 4.0 * (2 * B * T * C + n_weights) / HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flop)


def phase_mrf_tf32(mrf_mod, dev, power, inputs):
    """csrc/mrf_tf32.cu (route "tf32", the route of --matmul_precision
    default) against mrf_plain(passes=1) on the card
    within 1e-4 * max|plain| (each conv's operands rounded to TF32, fp32
    sums in another order) at the four v1 serving stages, the four training
    shapes and ragged (2, 997, C) at each width. At the serving and
    training shapes it is timed against csrc/mrf_tc.cu's one-pass build
    (before_ms, in turns: before, new, new, before), the 3xTF32 build, the
    plain version, the cuDNN chain at TF32 (library), the bound at the
    TF32 rate and the 18-launch chain's bytes floor; then its tile shapes
    at the serving stages, each held to the same limit. Launches here are
    comparisons: the path's count is the precision sweep's."""
    from radtts_tpu_torch.ops import precision

    gen = torch.Generator(dev).manual_seed(14)
    rows, max_err = [], 0.0
    for B, T, C in STAGES + TRAIN_STAGES + RAGGED + ODD_TC:
        if (B, T, C) in inputs:
            x, w = inputs[(B, T, C)]
        else:
            x = torch.randn(B, T, C, device=dev, generator=gen)
            w = random_mrf_weights(C, dev, gen)
        got = mrf_mod.mrf_cuda(x, w, route="tf32", passes=1)
        want = mrf_mod.mrf_plain(x, w, passes=1)
        torch.cuda.synchronize()
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        max_err = max(max_err, err)
        row = {"shape": [B, T, C], "tile": list(mrf_mod.tf32_tile(C)),
               "routed": mrf_mod.mrf_route(C, 3, 1), "max_abs_err": err,
               "max_abs_plain": scale}
        if (B, T, C) in STAGES + TRAIN_STAGES:
            xc, tw = library_inputs(x, w)
            bound_ms, bound_by, flop = tf32_bound(B, T, C)

            def new():
                return cuda_ms(lambda: mrf_mod.mrf_cuda(x, w, route="tf32",
                                                        passes=1))

            def before():
                return cuda_ms(lambda: mrf_mod.mrf_cuda(x, w, route="tc",
                                                        passes=1))
            turns = [before(), new(), new(), before()]
            with precision.scope("high"):
                library_ms = cuda_ms(lambda: library_mrf(xc, tw))
            row.update(
                ms=statistics.mean(turns[1:3]),
                before_ms=statistics.mean(turns[::3]), turns_ms=turns,
                three_pass_ms=cuda_ms(lambda: mrf_mod.mrf_cuda(x, w)),
                plain_ms=cuda_ms(lambda: mrf_mod.mrf_plain(x, w, passes=1)),
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                chain_bytes_floor_ms=mrf_bound(B, T, C)[4],
                gflop=flop / 1e9, serving=(B, T, C) in STAGES)
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            row["share_of_chain_floor"] = (row["chain_bytes_floor_ms"]
                                           / row["ms"])
            row["new_over_before"] = row["ms"] / row["before_ms"]
        log({"phase": "mrf_tf32_vs_plain", "card": power, **row})
        if not err <= 1e-4 * scale:
            raise AssertionError(f"mrf_tf32 disagrees at {(B, T, C)}: "
                                 f"{err} > 1e-4 * {scale}")
        rows.append(row)
    sweep = []
    for B, T, C in STAGES:
        x, w = inputs[(B, T, C)]
        want = mrf_mod.mrf_plain(x, w, passes=1)
        scale = want.abs().max().item()
        for tile in tf32_tiles(C):
            err = (mrf_mod.mrf_cuda(x, w, tile, "tf32", passes=1)
                   - want).abs().max().item()
            if not err <= 1e-4 * scale:
                raise AssertionError(f"mrf_tf32 tile {tile} disagrees at "
                                     f"{(B, T, C)}: {err} > 1e-4 * {scale}")
            row = {"phase": "mrf_tf32_tiles", "shape": [B, T, C],
                   "tile": list(tile),
                   "chosen": tile == mrf_mod.tf32_tile(C),
                   "max_abs_err": err, "ms": cuda_ms(
                       lambda: mrf_mod.mrf_cuda(x, w, tile, "tf32",
                                                passes=1))}
            log(row)
            sweep.append(row)
    return rows, max_err, sweep


def phase_mrf_padded(mrf_mod, dev, power):
    """The widths csrc/mrf.cu took before: the tensor-core kernels
    at ops/mrf.py:padded_width(C), through mrf_cuda's routing, at three
    passes (csrc/mrf_tc.cu) and one (csrc/mrf_tf32.cu): each call must
    count 18 launches of the route's kernel and none of csrc/mrf.cu, and
    come within 1e-4 * max|plain| of mrf_plain(passes); at PADDED_STAGES,
    PADDED_RAGGED and a C=16 stage of 5 resblocks (the narrow kernel at
    32). Timed at PADDED_STAGES beside csrc/mrf.cu on the same inputs
    (before: route="conv", fp32 FMA, also held to the limit), the plain
    version, the cuDNN chain at the same precision (library: fp32, or TF32
    at one pass), the bound (the C real channels' FLOP at the 3xTF32 or
    the TF32 rate, or the bytes) and the 18-launch chain's bytes floor."""
    from radtts_tpu_torch.ops import precision

    gen = torch.Generator(dev).manual_seed(17)
    rows = []
    cases = [(shape, (3, 7, 11)) for shape in PADDED_STAGES + PADDED_RAGGED]
    for (B, T, C), ks in cases + PADDED_RESBLOCKS:
        x = torch.randn(B, T, C, device=dev, generator=gen)
        w = random_mrf_weights(C, dev, gen, ks)
        timed = (B, T, C) in PADDED_STAGES
        if timed:
            xc, tw = library_inputs(x, w)
            before = mrf_mod.mrf_cuda(x, w, route="conv")
            before_err = (before - mrf_mod.mrf_plain(x, w)).abs().max().item()
            before_ms = cuda_ms(lambda: mrf_mod.mrf_cuda(x, w, route="conv"))
            del before
        for passes in (3, 1):
            route = mrf_mod.mrf_route(C, len(ks), passes)
            kernel = KERNEL_OF_ROUTE[route]
            count = {"tc": "tc_launches", "tf32": "tf32_launches"}[route]
            counts = (getattr(mrf_mod.mrf, count), mrf_mod.mrf.launches)
            got = mrf_mod.mrf_cuda(x, w, passes=passes)
            launched = (getattr(mrf_mod.mrf, count) - counts[0],
                        mrf_mod.mrf.launches - counts[1])
            want = mrf_mod.mrf_plain(x, w, passes=passes)
            torch.cuda.synchronize()
            scale = want.abs().max().item()
            err = (got - want).abs().max().item()
            tile = (mrf_mod.tc_tile(C) if passes == 3
                    else mrf_mod.tf32_tile(C))
            row = {"kernel": kernel, "passes": passes, "shape": [B, T, C],
                   "resblocks": len(ks),
                   "padded_width": mrf_mod.padded_width(C),
                   "tile": list(tile), "launches": launched[0],
                   "mrf_conv_launches": launched[1], "max_abs_err": err,
                   "max_abs_plain": scale}
            if timed:
                bound_ms, bound_by, flop, fp32_bound_ms, chain_ms = (
                    mrf_bound(B, T, C))
                if passes == 1:
                    bound_ms, bound_by, flop = tf32_bound(B, T, C)
                with precision.scope("highest" if passes == 3 else "high"):
                    library_ms = cuda_ms(lambda: library_mrf(xc, tw))
                row.update(
                    ms=cuda_ms(lambda: mrf_mod.mrf_cuda(x, w, passes=passes)),
                    before_ms=before_ms, before_max_abs_err=before_err,
                    plain_ms=cuda_ms(lambda: mrf_mod.mrf_plain(
                        x, w, passes=passes)),
                    library_ms=library_ms, bound_ms=bound_ms,
                    bound_by=bound_by, fp32_fma_bound_ms=fp32_bound_ms,
                    chain_bytes_floor_ms=chain_ms, gflop=flop / 1e9)
                row["share_of_bound"] = row["bound_ms"] / row["ms"]
                row["over_library"] = row["ms"] / row["library_ms"]
                row["over_before"] = row["ms"] / row["before_ms"]
            log({"phase": "mrf_padded", "card": power, **row})
            # two convs a dilation and resblock: 18 a stage of 3
            if (launched != (6 * len(ks), 0) or not err <= 1e-4 * scale
                    or (timed and not before_err <= 1e-4 * scale)):
                raise AssertionError(f"mrf padded route at {(B, T, C)}, "
                                     f"passes={passes}: {row}")
            rows.append(row)
    return rows


def phase_precision_sweep(synth, mrf_mod, dev, power):
    """The flagship Synthesizer at each --matmul_precision (the
    Synthesizer's matmul_precision, as the CLIs set it): one request
    through synthesize, then the 608-frame utterance (fixed durations, a
    seeded decoder residual) with the stage times (medians of 3) and the
    RTF inside ops/precision.py:scope, and its mel's and waveform's
    distance from highest's. Counted from 0 at each precision: 72
    launches a generator call of the 3xTF32 mrf_tc at highest and high,
    at default of the one-pass kernels mrf_route names (v1_launches), of
    no other MRF kernel. Then the utterance at default once more on
    csrc/mrf_tc.cu's one-pass build at every width (before, 72
    launches a call of it alone): the mel's and the waveform's distance
    from highest at default may be at most 1.5x the before run's. Then the
    counted FLOP of the utterance by stage at highest (ops/flops.py) and
    each over its measured time."""
    from radtts_tpu_torch.models.hifigan import denoiser_apply
    from radtts_tpu_torch.models.radtts import infer_durations, radtts_infer
    from radtts_tpu_torch.ops import flops, precision

    text, dur = (t.to(dev) for t in flagship_input(synth))
    meta = synth.model.meta
    g = meta["n_group_size"]
    gen = torch.Generator().manual_seed(3)
    res = (torch.randn(1, MAX_FRAMES // g, meta["n_mel_channels"] * g,
                       generator=gen) * 0.8).to(dev)
    spk = torch.zeros(1, dtype=torch.int64, device=dev)
    audio_s = MAX_FRAMES * synth.hop_length / synth.sampling_rate

    stages = {
        "durations": lambda: infer_durations(synth.model, spk, text),
        "decode": lambda: radtts_infer(synth.model, spk, text, 0.8,
                                       MAX_FRAMES, dur=dur,
                                       residual=res)["mel"],
        "vocoder_denoiser": lambda mel: denoiser_apply(
            synth.denoiser, synth.vocoder(mel), strength=0.01)}

    def utterance():
        _, t_dur = timed(stages["durations"])
        mel, t_dec = timed(stages["decode"])
        wav, t_voc = timed(lambda: stages["vocoder_denoiser"](mel))
        return mel, wav, {"durations": t_dur, "decode": t_dec,
                          "vocoder_denoiser": t_voc}

    out, paths, med_of = {}, {}, {}
    for p in PRECISIONS:
        synth.matmul_precision = p
        _reset_mrf(mrf_mod)
        (wavs, _), req_ms = timed(lambda: synth.synthesize(TEXTS[1], "ljs"))
        with torch.inference_mode(), precision.scope(p):
            runs = [utterance() for _ in range(3)]
        torch.cuda.synchronize()
        launches = _mrf_counts(mrf_mod)
        calls = 1 + len(runs)
        want = dict({k: 0 for k in launches}, **{
            k: n * calls for k, n in v1_launches(
                mrf_mod, 1 if p == "default" else 3).items()})
        mel, wav, _ = runs[-1]
        med = {k: statistics.median(r[2][k] for r in runs)
               for k in runs[0][2]}
        med_of[p] = med
        out[p] = (mel, wav)
        row = {"precision": p, "request_ms": req_ms, "stage_ms": med,
               "stage_ms_all": [r[2] for r in runs],
               "rtf": sum(med.values()) / 1e3 / audio_s,
               "launches": launches}
        if p != "highest":
            row["mel_dist_from_highest"] = (mel - out["highest"][0]).abs(
                ).max().item()
            row["mel_mae_from_highest"] = (mel - out["highest"][0]).abs(
                ).mean().item()
            row["mel_max_abs"] = out["highest"][0].abs().max().item()
            row["wav_dist_from_highest"] = (wav - out["highest"][1]).abs(
                ).max().item()
            row["wav_max_abs"] = out["highest"][1].abs().max().item()
        log({"phase": "precision_sweep_608", "card": power, **row})
        if launches != want:
            raise AssertionError(f"precision {p}: launches {launches}, "
                                 f"expected {want}")
        if not (np.isfinite(wavs[0]).all() and torch.isfinite(wav).all()):
            raise AssertionError(f"precision {p}: non-finite audio")
        if p != "highest":
            paths[f"serve_{p}"] = launches
    synth.matmul_precision = "highest"
    # the same utterance at default on csrc/mrf_tc.cu's one-pass build
    # (before): mrf_route's "tf32" read as "tc" for the run
    route = mrf_mod.mrf_route

    def before_route(C, n_resblocks=3, passes=3):
        got = route(C, n_resblocks, passes)
        return "tc" if got == "tf32" else got
    _reset_mrf(mrf_mod)
    mrf_mod.mrf_route = before_route
    try:
        with torch.inference_mode(), precision.scope("default"):
            runs = [utterance() for _ in range(3)]
        torch.cuda.synchronize()
    finally:
        mrf_mod.mrf_route = route
    launches = _mrf_counts(mrf_mod)
    _reset_mrf(mrf_mod)
    mel, wav, _ = runs[-1]
    dist = {"mel": ((mel - out["highest"][0]).abs().max().item(),
                    (out["default"][0] - out["highest"][0]).abs().max()
                    .item()),
            "wav": ((wav - out["highest"][1]).abs().max().item(),
                    (out["default"][1] - out["highest"][1]).abs().max()
                    .item())}
    med = {k: statistics.median(r[2][k] for r in runs) for k in runs[0][2]}
    log({"phase": "precision_default_before", "card": power,
         "stage_ms": med, "rtf": sum(med.values()) / 1e3 / audio_s,
         "launches": launches,
         "before_mel_dist_from_highest": dist["mel"][0],
         "mel_dist_from_highest": dist["mel"][1],
         "before_wav_dist_from_highest": dist["wav"][0],
         "wav_dist_from_highest": dist["wav"][1]})
    if launches != dict({k: 0 for k in launches},
                        mrf_tc_one_pass=72 * len(runs)):
        raise AssertionError(f"before launches {launches}")
    for name, (before, new) in dist.items():
        if not new <= 1.5 * before:
            raise AssertionError(f"{name} at default {new} from highest, "
                                 f"more than 1.5x the one-pass mrf_tc "
                                 f"build's {before}")
    # the model FLOP of the utterance by stage, counted at highest
    with torch.inference_mode():
        counted = {
            "durations": flops.count_matmul_flops(stages["durations"]),
            "decode": flops.count_matmul_flops(stages["decode"]),
            "vocoder_denoiser": flops.count_matmul_flops(
                lambda: stages["vocoder_denoiser"](out["highest"][0]))}
    total = sum(counted.values())
    total_ms = sum(med_of["highest"].values())
    log({"phase": "flagship_608_flops", "card": power, "gflop": {
        k: v / 1e9 for k, v in counted.items()}, "total_gflop": total / 1e9,
        "stage_ms": med_of["highest"],
        "tflops_by_stage": {k: counted[k] / med_of["highest"][k] / 1e9
                            for k in counted},
        "tflops": total / total_ms / 1e9})
    if not all(v > 0 for v in counted.values()):
        raise AssertionError(f"flagship FLOP count {counted}")
    _reset_mrf(mrf_mod)
    return paths


BF16_OVER = 4           # outputs of a bf16-head scan past 1e-4 * max
BF16_MEAN_RATIO = 0.1   # mean distance from the rounded over the unrounded


def bf16_scan_check(got, want, unrounded, scale):
    """(readings, ok) of a bf16-head scan's output `got` against the
    rounded plain scan `want`, with `unrounded` the plain scan of the same
    weights with the rounding cleared. A scan that rounds lies far nearer
    `want` than `unrounded` in the mean, and one that does not far nearer
    `unrounded`. Flips (an input within rounding of a bf16 boundary
    rounds the other way in the other scan's fp32 sums, and the
    recurrence carries it on) stay few, where a scan without the rounding
    puts tens of outputs past 1e-4 * max (the readings: PERF.md)."""
    err = (got - want).abs()
    r = {"max_abs_err": err.max().item(), "mean_abs_err": err.mean().item(),
         "mean_abs_err_from_unrounded": (got - unrounded).abs().mean()
         .item(),
         "over_1e-4_max": int((err > 1e-4 * scale).sum())}
    return r, (r["max_abs_err"] <= 1e-3 * scale
               and r["over_1e-4_max"] <= BF16_OVER
               and r["mean_abs_err"]
               <= BF16_MEAN_RATIO * r["mean_abs_err_from_unrounded"])


def phase_ar_scan_bf16(ar_mod, dev, power):
    """An AR step of config_ljs_agap.json's f0 model at its published
    width with bf16-stored head kernels (ops/fold_norms.py:
    store_conv_weights): the resident kernel and the barrier kernel, each
    rounding the head layers' inputs to bf16, against the repaired
    ar_scan_plain on the card at (1, 608) and ragged (3, 608), seeds
    13-15, held by
    bf16_scan_check: each output within 1e-3 * max|plain|, at most
    BF16_OVER of them past 1e-4 * max, and the mean distance from the
    rounded plain scan at most BF16_MEAN_RATIO of that from the unrounded
    one. The control: both kernels run once more with the rounding flag
    cleared (the scan before the repair), and the same check must reject
    each. With the time."""
    from radtts_tpu_torch.ops.fold_norms import store_conv_weights

    rows = []
    for (shape, lens, head), seed in itertools.product(AR_SHAPES[:2],
                                                       (13, 14, 15)):
        step = store_conv_weights(ar_step_at_width(head, dev))
        params, res, cproj = ar_inputs(step, shape, lens, dev, seed=seed)
        flags = ar_mod.widened(params)["head_bf16"]
        cleared = dict(ar_mod.widened(params),
                       head_bf16=[False] * len(flags))
        with torch.no_grad():
            want = ar_mod.ar_scan_plain(params, res, cproj)
            unrounded = ar_mod.ar_scan_plain(cleared, res, cproj)
            scale = want.abs().max().item()
            row = {"shape": [*shape, res.shape[2]], "lens": lens,
                   "seed": seed, "head_bf16": flags, "max_abs_plain": scale,
                   "outputs": want.numel(),
                   "plain_dist_from_unrounded": (want - unrounded).abs()
                   .max().item()}
            passed = {}
            for name, fn in (("resident", ar_mod.ar_scan),
                             ("barrier", ar_mod.ar_scan_cuda)):
                for tag, p in (("", params), ("_flag_cleared", cleared)):
                    row[name + tag], passed[name + tag] = bf16_scan_check(
                        fn(p, res, cproj), want, unrounded, scale)
            row["ms"] = cuda_ms(lambda: ar_mod.ar_scan(params, res, cproj))
        row["max_abs_err"] = max(row["resident"]["max_abs_err"],
                                 row["barrier"]["max_abs_err"])
        log({"phase": "ar_scan_bf16_head_vs_plain", "card": power, **row})
        if not (any(flags) and passed["resident"] and passed["barrier"]):
            raise AssertionError(f"ar_scan with bf16 heads: {row}")
        if passed["resident_flag_cleared"] or passed["barrier_flag_cleared"]:
            raise AssertionError(f"ar_scan with bf16 heads: the check "
                                 f"passed a scan that does not round {row}")
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# more than one device: data-parallel serving, data- and
# tensor-parallel RADTTS steps, the training CLI at WORLD_SIZE=2
# ---------------------------------------------------------------------------

DP2_TEXTS = TEXTS + ["It is well known that deep generative models have a "
                     "rich latent space."]
STEP_LAYOUTS = (("radtts_step_dp2", 2, 1), ("radtts_step_tp2", 2, 2),
                ("radtts_step_dp1_nccl", 1, 1))   # (phase, world, n_model)


def _vocoder_launches(vocoder, mrf_mod):
    """Hooks that record mrf_tc's launches in each call of `vocoder` (a
    replica's), into the returned list."""
    calls = []

    def pre(mod, args):
        calls.append(mrf_mod.mrf.tc_launches)

    def post(mod, args, out):
        calls[-1] = mrf_mod.mrf.tc_launches - calls[-1]
    return calls, [vocoder.register_forward_pre_hook(pre),
                   vocoder.register_forward_hook(post)]


def phase_serve_dp2(config, model, vocoder, denoiser, tp, mrf_mod, dev,
                    power):
    """Synthesizer(data_parallel=2) with both replicas on this card (they
    share its modules), against data_parallel=1 from the same seed: four
    texts, their durations scaled (token_dur_scaling) until the batch's
    budget is the flagship's 608 frames, must give data_parallel=1's
    durations and audio within 1e-3 * max; three texts give three wavs.
    The mrf_tc launches of each replica's vocoder call are counted from
    0 (72 each) and the wall time of both settings printed: two replicas
    on one card measure correctness, not a speed-up."""
    from radtts_tpu_torch.synthesizer import Synthesizer, frame_budget

    dc, mc = config["data_config"], config["model_config"]

    def make(n, scaling):
        return Synthesizer.from_parts(
            mc, model, vocoder, denoiser, encode_fn=tp.encode_text,
            speaker_id_fn=lambda name: 0, sampling_rate=dc["sampling_rate"],
            hop_length=dc["hop_length"], seed=5, token_dur_scaling=scaling,
            data_parallel=n, devices=[dev] * n)

    scaling = 1.0
    for _ in range(8):
        _, aux = make(1, scaling).synthesize(DP2_TEXTS, "ljs")
        longest = int(max(aux["n_frames"]))
        if frame_budget(longest, mc["n_group_size"]) == MAX_FRAMES:
            break
        scaling *= (MAX_FRAMES - 8) / longest
    else:
        raise AssertionError(f"no token_dur_scaling gives a {MAX_FRAMES}-"
                             f"frame budget (last {longest} frames)")
    one, two = make(1, scaling), make(2, scaling)
    (w1, a1), ms1 = timed(lambda: one.synthesize(DP2_TEXTS, "ljs"))
    calls, hooks = _vocoder_launches(two.replicas[1][2], mrf_mod)
    _reset_mrf(mrf_mod)
    try:
        (w2, a2), ms2 = timed(lambda: two.synthesize(DP2_TEXTS, "ljs"))
        launches = _mrf_counts(mrf_mod)
        per_replica = list(calls)
        (w3, a3), ms3 = timed(lambda: two.synthesize(DP2_TEXTS[:3], "ljs"))
    finally:
        for h in hooks:
            h.remove()
    walls = {"data_parallel_1": [ms1], "data_parallel_2": [ms2]}
    for _ in range(2):
        walls["data_parallel_1"].append(timed(
            lambda: one.synthesize(DP2_TEXTS, "ljs"))[1])
        walls["data_parallel_2"].append(timed(
            lambda: two.synthesize(DP2_TEXTS, "ljs"))[1])
    errs = [float(np.abs(x - y).max() / np.abs(y).max())
            for x, y in zip(w2, w1)]
    log({"phase": "serve_dp2_608", "card": power,
         "replicas": [str(r[0]) for r in two.replicas],
         "token_dur_scaling": scaling,
         "n_frames": [int(n) for n in a1["n_frames"]],
         "budget": frame_budget(max(a1["n_frames"]), mc["n_group_size"]),
         "durations_equal": bool(np.array_equal(a1["dur"], a2["dur"])),
         "wav_max_abs_err_over_max": errs,
         "mrf_tc_launches_by_replica": per_replica,
         "launches": launches, "wall_ms": walls,
         "note": "both replicas on one card: correctness and cost, not a "
                 "speed-up"})
    if not np.array_equal(a1["dur"], a2["dur"]) or max(errs) > 1e-3:
        raise AssertionError(f"data_parallel=2 vs 1: durations equal "
                             f"{np.array_equal(a1['dur'], a2['dur'])}, "
                             f"audio {errs}")
    if len(w3) != 3 or a3["dur"].shape[0] != 3:
        raise AssertionError(f"3 texts gave {len(w3)} wavs")
    if per_replica != [72, 72] or launches["mrf_tc"] != 144:
        raise AssertionError(f"mrf_tc by replica {per_replica}, {launches}")
    return launches


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(world, argv, timeout, env=None):
    """`world` processes of argv with the env contract (RANK, LOCAL_RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT), from the repository's root;
    their outputs by rank. Raises, with the failed rank's output, unless
    every rank exits 0; kills every rank it started."""
    base = dict(os.environ if env is None else env, MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(_free_port()), WORLD_SIZE=str(world))
    procs = [subprocess.Popen(
        argv, cwd=REPO, env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} of {world} exited "
                                 f"{p.returncode}:\n{out[-4000:]}")
    return logs


def step_rank(spec_path):
    """One rank of phase 10b (chip_smoke.py --step-rank SPEC, spawned by
    phase_radtts_step_parallel): the process group from the env contract
    (init_distributed), the config_ljs_decoder.json model from seed 1 on
    cuda:LOCAL_RANK; then for each of SPEC's layouts, from those weights
    and a fresh RAdam, the model sharded by that layout's mesh and its
    data rank's half of the batch: the first step (binarized, KL on)
    counted and its numbers kept, three more timed, then one with each
    all-reduce timed between synchronizations (the collectives' share).
    Writes SPEC's out/<layout>.RANK."""
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from radtts_tpu_torch.ops import mas as mas_mod
    from radtts_tpu_torch.ops import mel as mel_mod
    from radtts_tpu_torch.ops import mrf as mrf_mod
    from radtts_tpu_torch.parallel import shard_model
    from radtts_tpu_torch.parallel.mesh import (init_distributed,
                                                launch_env, local_device,
                                                make_mesh)
    from radtts_tpu_torch.synthesizer import resolve_device
    from radtts_tpu_torch.train.optim import build_optimizer
    from radtts_tpu_torch.train.trainer import (apply_trainable_mask,
                                                batch_to_device,
                                                build_trainable_mask,
                                                train_step)

    with open(spec_path) as f:
        spec = json.load(f)
    resolve_device()
    dev = local_device(launch_env()[2])
    torch.cuda.set_device(dev)
    world_mesh = init_distributed(dev, 1)
    with open(DECODER_CONFIG) as f:
        config = json.load(f)
    mc, tc = config["model_config"], config["train_config"]
    model, _, _ = _radtts_trainer(mc, dev, seed=1)
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    with np.load(spec["batch"]) as data:
        full = {k: data[k] for k in data.files}
    for phase, n_model in spec["layouts"]:
        mesh = world_mesh if n_model == 1 else make_mesh(n_model)
        model.load_state_dict(start)   # the layouts run whole, then sharded
        trainable = apply_trainable_mask(model, build_trainable_mask(model))
        opt = build_optimizer(trainable, "RAdam", 1e-4, 1e-6)
        axes = shard_model(model, opt, mesh)
        sharded = [p for n, p in model.named_parameters() if n in axes]
        n = full["text"].shape[0] // mesh.n_data
        batch = batch_to_device({k: v[mesh.data_rank * n:
                                       (mesh.data_rank + 1) * n]
                                 for k, v in full.items()}, dev)

        def step():
            return train_step(model, opt, trainable, batch, mc,
                              tc["loss_weights"], 1.0, True, True,
                              tc["grad_clip_val"], mesh=mesh,
                              sharded=sharded)

        torch.cuda.reset_peak_memory_stats(dev)
        _reset_counts(mas_mod, mel_mod, mrf_mod)
        (total, losses, gnorm), first_ms = timed(step)
        launches = _counts(mas_mod, mel_mod, mrf_mod)
        first = {"total": float(total), "grad_norm": float(gnorm),
                 **{k: float(v) for k, (v, _) in losses.items()}}
        ms = [timed(step)[1] for _ in range(3)]
        collective_ms = []
        all_reduce = dist.all_reduce

        def timed_all_reduce(*args, **kwargs):
            torch.cuda.synchronize(dev)
            tic = time.perf_counter()
            out = all_reduce(*args, **kwargs)
            torch.cuda.synchronize(dev)
            collective_ms.append((time.perf_counter() - tic) * 1e3)
            return out
        dist.all_reduce = timed_all_reduce
        try:
            _, with_timing_ms = timed(step)
        finally:
            dist.all_reduce = all_reduce
        result = {"rank": mesh.rank, "backend": mesh.backend,
                  "mesh": [mesh.n_data, mesh.n_model], "rows": int(n),
                  "frames": int(batch["output_lengths"].sum()),
                  "sharded_parameters": len(axes), "first": first,
                  "first_ms": first_ms, "step_ms": ms,
                  "launches_first_step": launches,
                  "collectives": len(collective_ms),
                  "collective_ms": sum(collective_ms),
                  "step_ms_collectives_timed": with_timing_ms,
                  "peak_allocated_gib": torch.cuda.max_memory_allocated(dev)
                  / 2 ** 30}
        with open(os.path.join(spec["out"], f"{phase}.{mesh.rank}"),
                  "w") as f:
            json.dump(result, f)
        del opt, trainable, batch
    dist.destroy_process_group()
    return 0


def phase_radtts_step_parallel(dev, power):
    """The RADTTS step at global (16, 112, 512) on config_ljs_decoder.json
    (1024-wide WN), binarized with the KL loss, on three layouts of ranks
    sharing this card (chip_smoke.py --step-rank): in one world of 2
    processes, 8 rows each (data parallel over gloo; rows 0-7 hold 512
    frames, rows 8-15 fewer, so the ranks' frame counts differ), then all
    16 rows at n_model=2 (512 WN channels a rank, gloo); and 1 process on
    NCCL (the only NCCL world one card runs). Each rank's first step must
    be within rtol 1e-3 (loss) and 2e-3 (grad norm) of the single-process
    step on the same 16 rows from the same weights, here, and launch
    mas_warp_kernel. Step ms (median of steps 2-4) and the collectives'
    ms in a step (each all-reduce between synchronizations): ranks that
    share one card measure correctness and the collectives' cost, not a
    speed-up."""
    from radtts_tpu_torch.ops import mas as mas_mod
    from radtts_tpu_torch.train.trainer import batch_to_device, train_step

    with open(DECODER_CONFIG) as f:
        config = json.load(f)
    mc, tc = config["model_config"], config["train_config"]
    B, N, T = RADTTS_STEP
    r = np.random.default_rng(11)
    in_lens = np.concatenate([[N] * (B // 2), r.integers(80, N + 1, B // 2)])
    out_lens = np.concatenate([[T] * (B // 2),
                               r.integers(360, T + 1, B // 2)])
    batch = radtts_step_batch(B, N, T, mc["n_mel_channels"], 2,
                              in_lens=in_lens, out_lens=out_lens)
    model, trainable, opt = _radtts_trainer(mc, dev, seed=1)
    mas_mod.mas.launches = 0
    (total, _, gnorm), single_ms = timed(lambda: train_step(
        model, opt, trainable, batch_to_device(batch, dev), mc,
        tc["loss_weights"], 1.0, True, True, tc["grad_clip_val"]))
    single = {"total": float(total), "grad_norm": float(gnorm),
              "ms": single_ms, "mas_launches": mas_mod.mas.launches}
    del model, trainable, opt
    torch.cuda.empty_cache()
    paths = {}
    with tempfile.TemporaryDirectory() as root:
        np.savez(os.path.join(root, "batch.npz"), **batch)
        for world in sorted({w for _, w, _ in STEP_LAYOUTS}, reverse=True):
            layouts = [(phase, n_model) for phase, w, n_model in STEP_LAYOUTS
                       if w == world]
            spec = os.path.join(root, f"world{world}.json")
            with open(spec, "w") as f:
                json.dump({"layouts": layouts, "out": root,
                           "batch": os.path.join(root, "batch.npz")}, f)
            tic = time.perf_counter()
            spawn_ranks(world, [sys.executable, os.path.abspath(__file__),
                                "--step-rank", spec], timeout=420)
            wall_s = time.perf_counter() - tic
            for phase, n_model in layouts:
                ranks = []
                for rank in range(world):
                    with open(os.path.join(root, f"{phase}.{rank}")) as f:
                        ranks.append(json.load(f))
                paths[phase] = _check_step_layout(
                    phase, world, n_model, ranks, single, wall_s, power)
    return paths


def _check_step_layout(phase, world, n_model, ranks, single, wall_s, power):
    """Log a layout's ranks; raise unless each ran on the backend the rule
    names, launched MAS and agrees with the single-process step. Returns
    the layout's launches, summed over its ranks."""
    want = "gloo" if world > 1 else "nccl"
    bad = [rk["rank"] for rk in ranks if rk["backend"] != want
           or rk["launches_first_step"]["mas"] < 1
           or abs(rk["first"]["total"] / single["total"] - 1) > 1e-3
           or abs(rk["first"]["grad_norm"] / single["grad_norm"] - 1)
           > 2e-3]
    coll = statistics.median(rk["collective_ms"] for rk in ranks)
    timed_ms = statistics.median(rk["step_ms_collectives_timed"]
                                 for rk in ranks)
    log({"phase": phase, "card": power, "world": world, "n_model": n_model,
         "backend": want, "single": single, "ranks": ranks,
         "median_step_ms_2_4": statistics.median(
             ms for rk in ranks for ms in rk["step_ms"]),
         "collective_ms_per_step": coll,
         "collective_share": coll / timed_ms, "world_seconds": wall_s,
         "note": "ranks share one card: correctness and the collectives' "
                 "cost, not a speed-up; world_seconds covers every layout "
                 "of the world"})
    if bad:
        raise AssertionError(f"{phase}: ranks {bad} disagree with the "
                             f"single-process step {single}: {ranks}")
    return {k: sum(rk["launches_first_step"][k] for rk in ranks)
            for k in ranks[0]["launches_first_step"]}


def phase_train_dp2_cli(root, power):
    """python -m radtts_tpu_torch.train at WORLD_SIZE=2 (the env contract,
    both ranks on this card: gloo) on the seeded dataset the training
    phase wrote, config_ljs_decoder.json at batch 8 a rank (the 16
    training wavs split between the data ranks), 2 epochs of one step
    (binarized from step 1), a validation and a checkpoint at step 0.
    Rank 0 alone logs the steps and the validation and writes model_0,
    which loads into one process, whose next step on the card is
    finite."""
    from radtts_tpu_torch.train.checkpoint import load_train_checkpoint
    from radtts_tpu_torch.train.trainer import batch_to_device, train_step

    out = os.path.join(root, "dp2")
    config = os.path.join(root, "decoder.json")
    tic = time.perf_counter()
    logs = spawn_ranks(2, [
        sys.executable, "-m", "radtts_tpu_torch.train", "-c", config, "-p",
        f"train_config.output_directory={out}", "train_config.epochs=2",
        "train_config.seed=0", "train_config.batch_size=8",
        "train_config.binarization_start_iter=1",
        "train_config.kl_loss_start_iter=1",
        "train_config.iters_per_checkpoint=2"], timeout=600)
    wall_s = time.perf_counter() - tic
    files = sorted(os.listdir(out))
    steps = [ln for ln in logs[0].splitlines() if ln.startswith("iter: ")]
    saw = [[ln for ln in log_.splitlines()
            if ln.startswith(("iter: ", "Validation loss"))] for log_ in logs]
    backends = [ln for log_ in logs for ln in log_.splitlines()
                if ln.startswith("> distributed:")]
    with open(DECODER_CONFIG) as f:
        mc = json.load(f)["model_config"]
    model, trainable, opt = _radtts_trainer(mc, torch.device("cuda"),
                                            seed=3)
    meta = load_train_checkpoint(os.path.join(out, "model_0"), model, opt,
                                 mc)
    B, N, T = 4, 60, 240
    total, _, gnorm = train_step(
        model, opt, trainable, batch_to_device(radtts_step_batch(
            B, N, T, mc["n_mel_channels"], 5), "cuda"), mc,
        {}, 1.0, True, True, 1.0)
    log({"phase": "train_dp2_cli", "card": power, "seconds": wall_s,
         "files": files, "rank0_lines": saw[0], "rank1_lines": saw[1],
         "backends": backends, "resumed_iteration": meta["iteration"],
         "next_step_total": float(total), "next_step_grad_norm":
         float(gnorm)})
    if (len(steps) != 2 or saw[1] or len(saw[0]) != 3
            or [f for f in files if f.startswith("model_")] != ["model_0"]
            or any(f.endswith(".tmp") for f in files)
            or len(backends) != 2 or not all("backend gloo" in b
                                             for b in backends)
            or meta["iteration"] != 0
            or not np.isfinite([float(total), float(gnorm)]).all()):
        raise AssertionError(f"train_dp2_cli: files {files}, rank 0 "
                             f"{saw[0]}, rank 1 {saw[1]}, {backends}")


def run_preflight(config_path, cache):
    """python -m radtts_tpu_torch.data -c config_path -j 2 (the dataset
    preflight) in a process of its own; returns (seconds, {cache file:
    mtime}) of the caches it warmed."""
    tic = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "radtts_tpu_torch.data", "-c", config_path,
         "-j", "2"], cwd=REPO, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"preflight failed:\n{proc.stderr[-3000:]}")
    return time.perf_counter() - tic, cache_files(cache)


def cache_files(cache):
    return {name: os.stat(os.path.join(cache, name)).st_mtime_ns
            for name in sorted(os.listdir(cache))}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "radtts_tpu_torch")):
        print("chip_smoke: radtts_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--step-rank"]:
        return step_rank(sys.argv[2])
    sys.path.insert(0, REPO)
    from radtts_tpu_torch.ops import ar_scan as ar_mod
    from radtts_tpu_torch.ops import lstm as lstm_mod
    from radtts_tpu_torch.ops import mas as mas_mod
    from radtts_tpu_torch.ops import mel as mel_mod
    from radtts_tpu_torch.ops import mrf as mrf_mod
    from radtts_tpu_torch.synthesizer import Synthesizer, resolve_device
    from radtts_tpu_torch.text import TextProcessing

    t_start = time.perf_counter()
    dev = resolve_device()
    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log({"phase": "device", "nvidia_smi": power,
         "torch": torch.__version__, "cuda": torch.version.cuda,
         "python": sys.version.split()[0],
         "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
         "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32})

    # one nvcc per source, all started together
    with ThreadPoolExecutor(8) as pool:
        builds = {name: pool.submit(fn) for name, fn in (
            ("mrf_tc", mrf_mod.build_tc),
            ("mrf_tc_one_pass", lambda: mrf_mod.build_tc(1)),
            ("mrf_tf32", mrf_mod.build_tf32),
            ("mrf_stack", mrf_mod.build_stack),
            ("mrf_conv", mrf_mod.build), ("mel", mel_mod.build),
            ("mas", mas_mod.build), ("ar_scan", ar_mod.build),
            ("lstm", lstm_mod.build))}
        for name, fut in builds.items():
            _, nvcc_log, build_s = fut.result()
            log({"phase": "build", "kernel": name, "seconds": build_s,
                 "ptxas": [ln.strip() for ln in nvcc_log.splitlines()
                           if "registers" in ln or "spill" in ln
                           or "arning" in ln or "Compiling entry" in ln]})
    tc_lib = mrf_mod._tc_libs[3]
    log({"phase": "smem", "mrf_tc_bytes_per_block": {
        f"C{C}:{tn}x{nwg}": tc_lib.radtts_mrf_tc_smem_bytes(C, tn, nwg)
        for C in (256, 96, 64, 32) for tn, nwg in tc_tiles(C)},
        "mrf_tc_narrow_weight_stages": {
            f"C{C}:{C}x{nwg}": tc_lib.radtts_mrf_tc_weight_stages(C, nwg)
            for C in (96, 64, 32) for nwg in (1, 2)},
        "mrf_tf32_bytes_and_weight_stages": {
            f"{tn}x{nwg}": [
                mrf_mod._tf32_lib.radtts_mrf_tf32_smem_bytes(tn, nwg),
                mrf_mod._tf32_lib.radtts_mrf_tf32_weight_stages(tn, nwg)]
            for tn in (128, 96, 64, 32) for nwg in (1, 2)},
        "mrf_stack_bytes_per_block": {
            f"C{C}:{rows}": mrf_mod._stack_lib.radtts_mrf_stack_smem_bytes(
                C, rows, 11) for C in (16, 8) for rows in STACK_TILES},
        "mel_bytes_per_block": mel_mod._lib.radtts_mel_smem_bytes(
            1024, mel_mod.kernel_constants(1024, 1024, 22050, 80, 0.0,
                                           8000.0)[2].size)})

    stages, max_err, inputs = phase_kernels(mrf_mod, dev)
    phase_tiles(mrf_mod, inputs)
    one_pass, one_pass_err = phase_mrf_tc_one_pass(mrf_mod, dev, power,
                                                   inputs)
    tf32_rows, tf32_err, tf32_tiles_rows = phase_mrf_tf32(mrf_mod, dev,
                                                          power, inputs)
    del inputs
    padded_rows = phase_mrf_padded(mrf_mod, dev, power)
    padded_tc = [r for r in padded_rows if r["passes"] == 3]
    padded_tf32 = [r for r in padded_rows if r["passes"] == 1]
    max_err["mrf_tc"] = max([max_err["mrf_tc"]]
                            + [r["max_abs_err"] for r in padded_tc])
    tf32_err = max([tf32_err] + [r["max_abs_err"] for r in padded_tf32])
    max_err["mrf_conv"] = max([max_err["mrf_conv"]] + [
        r["before_max_abs_err"] for r in padded_tc if "ms" in r])
    with open(CONFIG) as f:
        data_config = json.load(f)["data_config"]
    mel_kw = {k: data_config[k] for k in (
        "filter_length", "hop_length", "win_length", "n_mel_channels",
        "sampling_rate", "mel_fmin", "mel_fmax")}
    mel_rows, mel_err = phase_mel_kernels(mel_mod, dev, mel_kw)
    phase_guard(mrf_mod, dev)

    config, model, vocoder, denoiser = flagship_parts(dev)
    dc = config["data_config"]
    tp = TextProcessing(
        dc["symbol_set"], dc["cleaner_names"], dc["heteronyms_path"],
        dc["phoneme_dict_path"], p_phoneme=dc["p_phoneme"],
        handle_phoneme=dc["handle_phoneme"],
        handle_phoneme_ambiguous=dc["handle_phoneme_ambiguous"],
        prepend_space_to_text=dc["prepend_space_to_text"],
        append_space_to_text=dc["append_space_to_text"])
    synth = Synthesizer.from_parts(
        config["model_config"], model, vocoder, denoiser,
        encode_fn=tp.encode_text, speaker_id_fn=lambda name: 0,
        sampling_rate=dc["sampling_rate"], hop_length=dc["hop_length"],
        seed=0, device=dev)
    with torch.no_grad():
        phase_reference(synth, dev)

    serve_launches = phase_main_path(synth, mrf_mod, dev, power)
    precision_launches = phase_precision_sweep(synth, mrf_mod, dev, power)
    files_launches = phase_serve_files(synth, mrf_mod, dev, power)
    mods = (mas_mod, mel_mod, mrf_mod)
    ar_rows, ar_sweep = phase_ar_scan_kernel(ar_mod, dev, power)
    ar_bf16 = phase_ar_scan_bf16(ar_mod, dev, power)
    ar_pairs = phase_ar_scan_pair(ar_mod, dev, power)
    ar_split = phase_ar_scan_split_route(ar_mod, dev, power)
    probe = phase_handoff_probe(
        ar_mod, dev, power, ar_rows[0]["blocks"], ar_rows[0]["smem_bytes"],
        ar_rows[0]["handoffs_per_frame"], MAX_FRAMES)
    ar_trace = phase_ar_scan_trace(ar_mod, dev, power)
    lstm_rows = phase_lstm_kernel(lstm_mod, ar_mod, dev, power)
    gap_launches = {kind: phase_serve_gap(kind, vocoder, denoiser, tp, mods,
                                          dev, power)
                    for kind in GAP_CONFIGS}
    amp_serve_launches = phase_amp_serve(config, model, vocoder, denoiser,
                                         tp, mods, dev, power)
    fft_launches = phase_serve_dap_variant("fft", vocoder, denoiser, tp,
                                           mods, dev, power,
                                           convlstm_model=model)
    plain_w_launches = phase_serve_dap_variant("plain_w", vocoder, denoiser,
                                               tp, mods, dev, power)
    agap_bf16_launches = phase_serve_agap_bf16(vocoder, denoiser, tp, mods,
                                               dev, power)
    dp2_launches = phase_serve_dp2(config, model, vocoder, denoiser, tp,
                                   mrf_mod, dev, power)
    del synth, model, vocoder, denoiser
    v2_launches, v2_ms = phase_serve_v2(mrf_mod, dev, power)
    rb2_launches = phase_resblock2(mods, dev, power)
    train_launches = phase_training(mel_mod, mrf_mod, dev, data_config)
    phase_train_profile(dev, mel_kw)
    phase_train_vs_cpu(dev, mel_kw)
    mas_rows = phase_mas_kernel(mas_mod, dev, power)
    mas_warp, mas_block = mas_rows[:-1], mas_rows[-1]
    def after_radtts(root, files, dec_ckpt, voc, voc_cfg, text, dap_ckpt,
                     dap_config):
        out = phase_train_gap(mods, dev, power, root, files, dec_ckpt, voc,
                              voc_cfg, text)
        out["vc"] = phase_vc(mods, dev, power, root, dap_ckpt, dap_config)
        out["train_amp"] = phase_amp_train(mods, dev, power, root, files,
                                           dec_ckpt)
        out.update(phase_train_fft(mods, dev, power, root, files, dec_ckpt,
                                   voc, voc_cfg, text))
        out["train_plain_w"] = phase_train_plain_w(mods, dev, power, root,
                                                   files)
        out["train_audio_samples"] = phase_train_audio_samples(
            mods, dev, power, root, files, dec_ckpt, voc, voc_cfg)
        phase_train_dp2_cli(root, power)
        return out
    radtts_launches, gap_train = phase_train_radtts(
        mas_mod, mel_mod, mrf_mod, dev, power, then=after_radtts)
    phase_radtts_step(mas_mod, dev, power)
    step_paths = phase_radtts_step_parallel(dev, power)
    phase_radtts_vs_cpu(dev)
    for kind, path in GAP_CONFIGS.items():
        phase_radtts_vs_cpu(dev, config_path=path,
                            unfreeze="durf0energyvpred",
                            phase=f"{kind}_train_step_card_vs_cpu")
    phase_simple_conv_cudnn(dev, power)
    phase_griffin_lim(mods, dev, power)
    # launches by path of every kernel: the earlier paths counted the MRF
    # kernels (and mel, mas; serve and serve_files lstm too) only; the
    # others never launch there
    paths = {"serve": serve_launches, "serve_files": files_launches,
             "serve_v2": v2_launches, "train": train_launches,
             "train_radtts": radtts_launches,
             "serve_bgap": gap_launches["bgap"],
             "serve_agap": gap_launches["agap"],
             "train_gap": gap_train["train_gap"],
             "serve_gap_files": gap_train["serve_gap_files"],
             "vc": gap_train["vc"], "serve_amp": amp_serve_launches,
             "train_amp": gap_train["train_amp"], "resblock2": rb2_launches,
             "serve_fft": fft_launches, "train_fft": gap_train["train_fft"],
             "serve_fft_files": gap_train["serve_fft_files"],
             "serve_plain_w": plain_w_launches,
             "train_plain_w": gap_train["train_plain_w"],
             "serve_agap_bf16": agap_bf16_launches,
             "train_audio_samples": gap_train["train_audio_samples"],
             "serve_dp2": dp2_launches, **step_paths,
             **precision_launches}
    # every path counts the one-pass kernels, and only serve_default runs
    # them (as mrf_route names them; the precision sweep checks the counts)
    stray = {p: (c.get("mrf_tf32"), c.get("mrf_tc_one_pass"))
             for p, c in paths.items() if p != "serve_default" and (
                 c.get("mrf_tf32") != 0 or c.get("mrf_tc_one_pass") != 0)}
    if stray:
        raise AssertionError(f"one-pass launches (mrf_tf32, "
                             f"mrf_tc_one_pass) off serve_default (or not "
                             f"counted): {stray}")

    def by_path(kernel):
        return {p: c.get(kernel, 0) for p, c in paths.items()}
    lstm_paths = {p: c["lstm"] for p, c in paths.items() if "lstm" in c}

    def mrf_entry(kernel, source, replaces, also_replaces, shapes=None,
                  ms_key="ms"):
        """Times summed over the serving stages the kernel runs (`shapes`:
        over these stages, with its time under ms_key)."""
        serving = [s for s in stages if (s["kernel"] == kernel and s["serving"]
                                         if shapes is None
                                         else tuple(s["shape"]) in shapes)]

        def total(key):
            return sum(s[key] for s in serving)
        paths_k = by_path(kernel)
        return {
            "name": kernel,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "also_replaces": also_replaces,
            "launches": sum(paths_k.values()),
            "launches_by_path": paths_k,
            "max_abs_err": max_err[kernel],
            "ms": total(ms_key),
            "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": ("operations" if all(
                s["bound_by"] == "operations" for s in serving) else "bytes"),
            "fp32_fma_bound_ms": total("fp32_fma_bound_ms"),
            "chain_bytes_floor_ms": total("chain_bytes_floor_ms"),
            "library_ms": total("library_ms"),
            "stages": [{k: s[k] for k in (
                "shape", "grid", "tile_rows", "ms", "plain_ms", "library_ms",
                "bound_ms", "bound_by", "fp32_fma_bound_ms",
                "chain_bytes_floor_ms", "conv_route_ms", "max_abs_err")
                if k in s} for s in serving],
        }

    train_row = mel_rows[0]   # (16, 8192): the training step's shape
    log({"kernels": [
        dict(mrf_entry("mrf_tc", "radtts_tpu_torch/csrc/mrf_tc.cu",
                       "radtts_tpu/ops/pallas_mrf.py:177",
                       ["radtts_tpu/ops/pallas_mrf.py:121 (at C=128, 64)",
                        "radtts_tpu/ops/pallas_mrf.py:231 (C=32)"]),
             note="sums over the four v1 MRF stages of one 608-frame "
                  "utterance; bound_ms at the 3xTF32 rate (495/3 TFLOP/s), "
                  "fp32_fma_bound_ms at 67 TFLOP/s; padded: the widths "
                  "csrc/mrf.cu took before, run at padded_width(C) "
                  "(before_ms: csrc/mrf.cu on the same inputs; library_ms "
                  "the cuDNN fp32 chain)",
             padded=padded_tc), {
        "name": "mrf_tf32",
        "route": "cuda",
        "source": "radtts_tpu_torch/csrc/mrf_tf32.cu",
        "replaces": "radtts_tpu/ops/pallas_mrf.py:177",
        "also_replaces": ["radtts_tpu/ops/pallas_mrf.py:121 (at C=128, 64)",
                          "radtts_tpu/ops/pallas_mrf.py:231 (C=32)"],
        "launches": sum(by_path("mrf_tf32").values()),
        "launches_by_path": by_path("mrf_tf32"),
        "max_abs_err": tf32_err,
        **{key: sum(r[key] for r in tf32_rows if r.get("serving"))
           for key in ("ms", "before_ms", "three_pass_ms", "plain_ms",
                       "library_ms", "bound_ms", "chain_bytes_floor_ms")},
        "bound_by": "operations" if all(
            r["bound_by"] == "operations" for r in tf32_rows
            if r.get("serving")) else "bytes",
        "stages": [r for r in tf32_rows if r.get("serving")],
        "training": [r for r in tf32_rows
                     if "ms" in r and not r["serving"]],
        "ragged": [{k: r[k] for k in ("shape", "max_abs_err",
                                      "max_abs_plain")}
                   for r in tf32_rows if "ms" not in r],
        "tiles": tf32_tiles_rows,
        "padded": padded_tf32,
        "note": "one TF32 pass, the route of --matmul_precision default "
                "(mrf_route), against "
                "mrf_plain(passes=1); sums over the four v1 MRF stages of "
                "one 608-frame utterance; before_ms csrc/mrf_tc.cu's "
                "one-pass build on the same inputs, in turns; bound_ms at "
                "the TF32 rate (495 TFLOP/s); chain_bytes_floor_ms the 18 "
                "launches' activation bytes at 3.35 TB/s; library_ms the "
                "cuDNN conv chain at TF32; three_pass_ms the 3xTF32 build"}, {
        "name": "mrf_tc_one_pass",
        "route": "cuda",
        "source": "radtts_tpu_torch/csrc/mrf_tc.cu (built with "
                  "-DMRF_TC_PASSES=1)",
        "replaces": "radtts_tpu/ops/pallas_mrf.py:177",
        "also_replaces": ["radtts_tpu/ops/pallas_mrf.py:121 (at C=128, 64)",
                          "radtts_tpu/ops/pallas_mrf.py:231 (C=32)"],
        "launches": sum(by_path("mrf_tc_one_pass").values()),
        "launches_by_path": by_path("mrf_tc_one_pass"),
        "max_abs_err": one_pass_err,
        "ms": sum(r["ms"] for r in one_pass),
        "three_pass_ms": sum(r["three_pass_ms"] for r in one_pass),
        "plain_ms": sum(r["plain_ms"] for r in one_pass),
        "bound_ms": sum(r["bound_ms"] for r in one_pass),
        "bound_by": ("operations" if all(r["bound_by"] == "operations"
                                         for r in one_pass) else "bytes"),
        "library_ms": sum(r["library_ms"] for r in one_pass),
        "stages": one_pass,
        "note": "one TF32 pass, replaced by mrf_tf32 as the route of "
                "--matmul_precision default (0 launches on every path; "
                "route='tc', passes=1), against mrf_plain(passes=1); sums "
                "over the four v1 MRF stages of one 608-frame utterance; "
                "bound_ms at the TF32 rate (495 TFLOP/s); library_ms the "
                "cuDNN conv chain at TF32; three_pass_ms the 3xTF32 build "
                "on the same inputs"},
        dict(mrf_entry("mrf_stack", "radtts_tpu_torch/csrc/mrf_stack.cu",
                       "radtts_tpu/ops/pallas_mrf.py:121 (at C=16, 8)", []),
             note="sums over HiFi-GAN V2's C=16 and C=8 stages of one "
                  "608-frame utterance, one launch each; bound_ms at the "
                  "3xTF32 rate, fp32_fma_bound_ms at 67 TFLOP/s (its "
                  "products are fp32 FMA); conv_route_ms per stage is "
                  "csrc/mrf.cu on the same inputs", v2_vocoder_ms=v2_ms),
        dict(mrf_entry("mrf_conv", "radtts_tpu_torch/csrc/mrf.cu",
                       "radtts_tpu/ops/pallas_mrf.py:121",
                       ["radtts_tpu/ops/pallas_mrf.py:231"],
                       shapes=STACK_STAGES, ms_key="conv_route_ms"),
             note="no route names it any more (0 launches on every "
                  "path; mrf_cuda(route='conv') runs it by name); times "
                  "are route='conv' on the V2 C=16 and C=8 stages' inputs, "
                  "summed, with their plain, library and bound times; "
                  "own_stages: the widths it took before, 608 frames of "
                  "stages at C=96, 48, 24 and 160, where mrf_tc_ms and "
                  "mrf_tf32_ms are the padded tensor-core routes on the "
                  "same inputs (library_ms: the cuDNN fp32 chain, "
                  "library_tf32_ms at TF32; its products are fp32 FMA: "
                  "fp32_fma_bound_ms; bound_ms at the 3xTF32 rate, "
                  "tf32_bound_ms at the TF32 rate)",
             own_stages=[{
                 "shape": r["shape"], "ms": r["before_ms"],
                 "max_abs_err": r["before_max_abs_err"],
                 "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
                 "library_tf32_ms": r1["library_ms"],
                 "bound_ms": r["bound_ms"], "tf32_bound_ms": r1["bound_ms"],
                 "fp32_fma_bound_ms": r["fp32_fma_bound_ms"],
                 "chain_bytes_floor_ms": r["chain_bytes_floor_ms"],
                 "mrf_tc_ms": r["ms"], "mrf_tf32_ms": r1["ms"]}
                 for r, r1 in zip(padded_tc, padded_tf32) if "ms" in r]), {
        "name": "mel",
        "route": "cuda",
        "source": "radtts_tpu_torch/csrc/mel.cu",
        "replaces": "radtts_tpu/ops/pallas_mel.py:74",
        "launches": sum(by_path("mel").values()),
        "launches_by_path": by_path("mel"),
        "max_abs_err": mel_err,
        "ms": train_row["ms"],
        "plain_ms": train_row["plain_ms"],
        "bound_ms": train_row["bound_ms"],
        "bound_by": train_row["bound_by"],
        "library_ms": None,
        "composite_ms": train_row["composite_ms"],
        "design_gflop": train_row["design_gflop"],
        "note": "times at (16, 8192), the training step's shape; no single "
                "PyTorch call computes the log-mel: composite_ms is the "
                "cuFFT composite (torch.stft + mel matmul + log(clamp)), "
                "timed for information",
        "shapes": [{k: r[k] for k in ("shape", "ms", "plain_ms",
                                      "composite_ms", "bound_ms", "bound_by",
                                      "design_gflop", "max_abs_err",
                                      "grad_max_abs_err")}
                   for r in mel_rows],
    }, {
        "name": "mas",
        "route": "cuda",
        "source": "radtts_tpu_torch/csrc/mas.cu (mas_warp_kernel)",
        "replaces": "radtts_tpu/ops/mas.py:70 (XLA scan, not Pallas)",
        "launches": sum(by_path("mas").values()),
        "launches_by_path": by_path("mas"),
        "max_abs_err": max(r["max_abs_err"] for r in mas_warp),
        "ms": mas_warp[0]["ms"],
        "before_ms": mas_warp[0]["before_ms"],
        "plain_ms": mas_warp[0]["plain_ms"],
        "bound_ms": mas_warp[0]["bound_ms"],
        "bound_by": mas_warp[0]["bound_by"],
        "library_ms": None,
        "note": "one warp an utterance (N <= 1024, mas_route; 1 to 32 "
                "tokens a lane); times at (16, "
                "512, 112), the flagship training batch; before_ms: the "
                "block kernel on the same inputs; no PyTorch call computes "
                "MAS; bound_ms is the bytes floor, but the dependence over "
                "frames (a chain of out_len steps an utterance) bounds it",
        "shapes": [{k: r[k] for k in (
            "shape", "tokens_a_lane", "warp_choices_in_smem", "ms",
            "before_ms", "plain_ms",
            "bound_ms", "bound_by", "cells_different",
            "before_cells_different", "max_abs_err")} for r in mas_warp],
    }, {
        "name": "mas_block",
        "route": "cuda",
        "source": "radtts_tpu_torch/csrc/mas.cu (mas_kernel)",
        "replaces": "radtts_tpu/ops/mas.py:70 (XLA scan, not Pallas)",
        "launches": sum(by_path("mas_block").values()),
        "launches_by_path": by_path("mas_block"),
        "max_abs_err": mas_block["max_abs_err"],
        "ms": mas_warp[0]["before_ms"],
        "plain_ms": mas_warp[0]["plain_ms"],
        "bound_ms": mas_warp[0]["bound_ms"],
        "bound_by": mas_warp[0]["bound_by"],
        "library_ms": None,
        "note": "The block kernel, one block an utterance, the route of texts "
                "of N > 1024 tokens (0 launches on every path); held at "
                f"{mas_block['shape']} ({mas_block['ms']} ms there); ms, "
                "plain_ms and bound_ms at (16, 512, 112), route='block'",
    }, {
        "name": "ar_scan",
        "route": "cuda",
        "source": "radtts_tpu_torch/csrc/ar_scan.cu "
                  "(ar_scan_resident_kernel)",
        "replaces": "radtts_tpu/models/attributes.py:458 (XLA scan, not "
                    "Pallas)",
        "launches": sum(by_path("ar_scan").values()),
        "launches_by_path": by_path("ar_scan"),
        "max_abs_err": max(r["max_abs_err"]
                           for r in ar_rows + ar_pairs + ar_bf16 + ar_split),
        "ms": ar_rows[0]["ms"],
        "before_ms": ar_rows[0]["before_ms"],
        "plain_ms": ar_rows[0]["plain_ms"],
        "bound_ms": ar_rows[0]["bound_ms"],
        "bound_by": ar_rows[0]["bound_by"],
        "library_ms": None,
        "chain_floor_ms": probe["handoff_ms"],
        "barrier_chain_ms": probe["barrier_ms"],
        "handoffs_per_frame": ar_rows[0]["handoffs_per_frame"],
        "us_per_frame": ar_rows[0]["us_per_frame"],
        "note": "weights resident in shared memory (or, split, the rows "
                "that do not fit read from L2: `split`, H = 1024 and "
                "1022 at (1, 32), beside the barrier kernel, with its "
                "chain floor), one handoff a phase; "
                "times at (1, 608, 1), one AR flow of config_ljs_agap.json's "
                "f0 model over the flagship utterance (an AGAP request pairs "
                "f0's and energy's flows: 2 launches); before_ms: the barrier "
                "kernel on the same inputs; chain_floor_ms: the handoff "
                "probe, 608 x 6 empty phases on the same grid "
                "(barrier_chain_ms: the same with the barrier kernel's "
                "grid barrier); no "
                "PyTorch call computes the AR inverse; bound_ms: the FLOP "
                "at 67 TFLOP/s fp32 or the bytes (weights once, residual, "
                "context_proj, output) at 3.35 TB/s",
        "shapes": [{k: r[k] for k in ("shape", "lens", "head", "blocks",
                                      "smem_bytes", "ms", "before_ms",
                                      "plain_ms", "us_per_frame",
                                      "bound_ms", "bound_by",
                                      "max_abs_err")} for r in ar_rows],
        "pairs": ar_pairs,
        "bf16_heads": ar_bf16,
        "blocks_sweep": ar_sweep,
        "handoff_probe": probe,
        "frame_trace": ar_trace,
        "split": [{k: r[k] for k in (
            "shape", "H", "padded_H", "route", "blocks", "smem_bytes",
            "overflow_bytes_per_frame", "ms", "kernel_ms",
            "frame_trace_us", "before_ms", "plain_ms", "us_per_frame",
            "bound_ms", "bound_by",
            "chain_floor_ms", "handoff_probe_ms", "l2_read_bytes_per_s",
            "max_abs_err")} for r in ar_split],
    }, {
        "name": "lstm",
        "route": "cuda",
        "source": "radtts_tpu_torch/csrc/lstm.cu (lstm_resident_kernel)",
        "replaces": "radtts_tpu/ops/lstm.py:bilstm_apply (XLA scan, not "
                    "Pallas); before: cuDNN on packed sequences",
        "launches": sum(lstm_paths.values()),
        "launches_by_path": lstm_paths,
        "max_abs_err": max(r["max_abs_err"] for r in lstm_rows),
        "ms": lstm_rows[0]["ms"],
        "kernel_ms": lstm_rows[0]["kernel_ms"],
        "before_ms": lstm_rows[0]["before_ms"],
        "plain_ms": lstm_rows[0]["plain_ms"],
        "bound_ms": lstm_rows[0]["bound_ms"],
        "bound_by": "operations",
        "library_ms": lstm_rows[0]["before_ms"],
        "chain_floor_ms": lstm_rows[0]["chain_floor_ms"],
        "note": "one launch a masked LSTM run (both directions), weights "
                "resident in shared memory, one handoff a step; times at "
                "(16, 870, 128), a frame-level DAP's BiLSTM of the "
                "benchmark's DAP cell; ms: the layer's call (the input "
                "projection and the launch), kernel_ms the kernel's device "
                "time; before_ms (= library_ms): MaskedLSTM's cuDNN path "
                "on packed sequences, same inputs; launches_by_path: the "
                "paths that count lstm_cuda.launches (the precision sweep's "
                "and serve_dp2 count the MRF kernels only); bound_ms: "
                "2 sum(len_b) 4H H D FLOP at 67 TFLOP/s; chain_floor_ms: "
                "the handoff probe, T handoffs on the same grid",
        "shapes_checked": len(lstm_rows),
        "shapes": lstm_rows,
    }, {
        "name": "ar_scan_barrier",
        "route": "cuda",
        "source": "radtts_tpu_torch/csrc/ar_scan.cu (ar_scan_kernel)",
        "replaces": "radtts_tpu/models/attributes.py:458 (XLA scan, not "
                    "Pallas)",
        "launches": sum(by_path("ar_scan_barrier").values()),
        "launches_by_path": by_path("ar_scan_barrier"),
        "max_abs_err": max([r["before_max_abs_err"]
                            for r in ar_rows + ar_split]),
        "ms": ar_rows[0]["before_ms"],
        "plain_ms": ar_rows[0]["plain_ms"],
        "bound_ms": ar_rows[0]["bound_ms"],
        "bound_by": ar_rows[0]["bound_by"],
        "library_ms": None,
        "wide": [{"shape": r["shape"], "H": r["H"], "ms": r["before_ms"],
                  "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                  "bound_by": r["bound_by"],
                  "max_abs_err": r["before_max_abs_err"]} for r in ar_split],
        "note": "The barrier kernel (a grid barrier, weights from L2), "
                "which no route names any more (0 launches on every "
                "path; ar_scan_cuda runs it by name): the before of the "
                "split route, held and timed at H = 1024 and 1022, (1, "
                "32): `wide`; times at (1, 608, 1) on the resident "
                "kernel's inputs",
    }]})
    log({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(power, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
