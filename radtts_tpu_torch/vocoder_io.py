"""Vocoder checkpoint loading: a reference HiFi-GAN checkpoint
({'generator': state_dict}, or the bare state dict) and its JSON config ->
the port's Generator and denoiser (the JAX package's
radtts_tpu/vocoder_io.py:load_vocoder)."""

import json

import torch

from radtts_tpu_torch.models.hifigan import (denoiser_init,
                                             generator_from_reference)


def load_vocoder(vocoder_path, config_path, device=None):
    """(Generator, Denoiser) on `device` (None: CUDA, raising without it),
    eval and without grad. p_blurring is set from the file name, as the
    reference does; it acts only in vocoder training, never here. The
    denoiser's bias spectrum is one generator call on the device."""
    # imported here: synthesizer.py imports this module
    from radtts_tpu_torch.synthesizer import resolve_device

    device = resolve_device(device)
    with open(config_path) as f:
        h = json.load(f)
    h.setdefault("gaussian_blur", {})["p_blurring"] = (
        0.5 if "blur" in vocoder_path else 0.0)
    ckpt = torch.load(vocoder_path, map_location="cpu", weights_only=True)
    state_dict = ckpt["generator"] if "generator" in ckpt else ckpt
    generator = generator_from_reference(state_dict, h).to(device)
    generator = generator.eval().requires_grad_(False)
    with torch.no_grad():
        denoiser = denoiser_init(generator)
    return generator, denoiser.eval()
