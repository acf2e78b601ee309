"""The system under test, built from a configuration and seeded weights:
radtts_tpu_torch's Synthesizer over its RADTTS model, HiFi-GAN generator
and denoiser, with the port's own text frontend. Everything the program
derives from the weights (the 1x1 inverses, the denoiser's bias spectrum,
the kernels' packed weights) it derives itself, here or on its first
call.
"""

import numpy as np
import torch


def text_processing(cls, dc):
    """A TextProcessing class built as the program's dataset builds it."""
    return cls(dc["symbol_set"], dc["cleaner_names"], dc["heteronyms_path"],
               dc["phoneme_dict_path"], p_phoneme=dc["p_phoneme"],
               handle_phoneme=dc["handle_phoneme"],
               handle_phoneme_ambiguous=dc["handle_phoneme_ambiguous"],
               prepend_space_to_text=dc["prepend_space_to_text"],
               append_space_to_text=dc["append_space_to_text"],
               add_bos_eos_to_text=dc["add_bos_eos_to_text"])


def build(config, weights, device, matmul_precision):
    """A Synthesizer holding `weights` (the program's modules take the
    tensors as they are, on the device)."""
    from radtts_tpu_torch.models.hifigan import Generator, denoiser_init
    from radtts_tpu_torch.models.radtts import RADTTS
    from radtts_tpu_torch.synthesizer import Synthesizer
    from radtts_tpu_torch.text import TextProcessing

    mc, dc = config["model_config"], config["data_config"]
    model = RADTTS(mc)
    model.load_state_dict({k: v for k, v in weights.items()
                           if not k.startswith("vocoder.")},
                          strict=True, assign=True)
    for module in model.modules():
        if hasattr(module, "precompute_inverse"):
            module.precompute_inverse()
    model.eval().requires_grad_(False)
    vocoder = Generator(config["vocoder"]["config"], mc["n_mel_channels"])
    vocoder.load_state_dict({k[len("vocoder."):]: v
                             for k, v in weights.items()
                             if k.startswith("vocoder.")},
                            strict=True, assign=True)
    vocoder.eval().requires_grad_(False)
    with torch.inference_mode():
        denoiser = denoiser_init(vocoder, **config["denoiser"])
    tp = text_processing(TextProcessing, dc)
    speakers = config["speakers"]
    synth = Synthesizer.from_parts(
        mc, model, vocoder, denoiser,
        encode_fn=lambda t: np.asarray(tp.encode_text(t), np.int64),
        speaker_id_fn=lambda name: speakers[name],
        sampling_rate=dc["sampling_rate"], hop_length=dc["hop_length"],
        matmul_precision=matmul_precision, device=device,
        **config["synthesis"])
    return synth
