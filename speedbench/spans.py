"""What the benchmark records around the program's calls: every
synthesize call (its inputs, the noise seed it gets, its outputs), and in
a traced run a span around each call into a layer.

The spans wrap the names the program's modules look up at call time:
synthesizer.infer_durations ("durations"), synthesizer.radtts_infer
("decode"), synthesizer.denoiser_apply ("denoiser"),
models.radtts.attribute_model_infer and models.radtts.agap_infer_multi
("attributes"), models.hifigan.mrf ("mrf") and the vocoder's forward
("vocoder"). Each span is a profiler range (speedbench.<name>) and, on the
card, a pair of CUDA events, whose elapsed time is the device's time from
reaching the span's start to reaching its end.
"""

import contextlib
import threading
import time

import torch

SEED_MIX = 0x9E3779B97F4A7C15


def dispatch_seed(seed, idx):
    """The noise seed of the idx-th synthesize call of a run."""
    return (int(seed) * 1000003 + (idx + 1) * SEED_MIX) % 2 ** 63


class Recorder:
    def __init__(self, seed, traced, device):
        self.seed = seed
        self.traced = traced
        self.cuda = torch.device(device).type == "cuda"
        self.dispatches = []
        self.spans = []
        self.phase = "setup"
        self._local = threading.local()
        self._undo = []

    # -- spans ---------------------------------------------------------
    def _stack(self):
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack

    @contextlib.contextmanager
    def span(self, name, **info):
        stack = self._stack()
        rec = {"name": name, "parents": [s["name"] for s in stack],
               "dispatch": getattr(self._local, "dispatch", None),
               "phase": self.phase, **info}
        if self.cuda:
            rec["ev"] = (torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
            rec["ev"][0].record()
        stack.append(rec)
        rec["t0"] = time.perf_counter()
        try:
            with torch.profiler.record_function("speedbench." + name):
                yield rec
        finally:
            rec["t1"] = time.perf_counter()
            stack.pop()
            if self.cuda:
                rec["ev"][1].record()
            self.spans.append(rec)

    def _wrap(self, owner, attr, name, info=None):
        orig = getattr(owner, attr)

        def wrapped(*args, **kwargs):
            extra = info(*args, **kwargs) if info else {}
            with self.span(name, **extra):
                return orig(*args, **kwargs)

        setattr(owner, attr, wrapped)
        self._undo.append((owner, attr, orig))

    # -- installation --------------------------------------------------
    def install(self, synth):
        """Record every synthesize call of `synth`; in a traced run also
        wrap the layers (module attributes, restored by uninstall)."""
        orig = synth.synthesize

        def synthesize(texts, speaker, **knobs):
            texts = [texts] if isinstance(texts, str) else list(texts)
            idx = len(self.dispatches)
            seed = dispatch_seed(self.seed, idx)
            synth.generator.manual_seed(seed)
            rec = {"idx": idx, "texts": texts, "speaker": speaker,
                   "knobs": dict(knobs), "gen_seed": seed,
                   "phase": self.phase, "t0": time.perf_counter()}
            self.dispatches.append(rec)
            self._local.dispatch = idx
            try:
                if self.traced:
                    with self.span("synthesize"):
                        wavs, aux = orig(texts, speaker, **knobs)
                else:
                    wavs, aux = orig(texts, speaker, **knobs)
            finally:
                self._local.dispatch = None
            rec["t1"] = time.perf_counter()
            rec["wavs"] = wavs
            rec["aux"] = {k: aux[k] for k in ("dur", "n_frames", "f0",
                                              "energy_avg") if k in aux}
            return wavs, aux

        synth.synthesize = synthesize
        self._undo.append((synth, "synthesize", None))
        if not self.traced:
            return
        from radtts_tpu_torch import synthesizer
        from radtts_tpu_torch.models import hifigan, radtts
        self._wrap(synthesizer, "infer_durations", "durations")
        self._wrap(synthesizer, "radtts_infer", "decode")
        self._wrap(synthesizer, "denoiser_apply", "denoiser")
        self._wrap(radtts, "attribute_model_infer", "attributes")
        self._wrap(radtts, "agap_infer_multi", "attributes")
        self._wrap(hifigan, "mrf", "mrf",
                   lambda x, weights: {"shape": tuple(x.shape),
                                       "kernel_sizes": tuple(
                                           w["w1"].shape[1]
                                           for w in weights)})
        self._wrap(synth.vocoder, "forward", "vocoder")

    def uninstall(self):
        for owner, attr, orig in reversed(self._undo):
            if orig is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, orig)
        self._undo = []

    # -- readings ------------------------------------------------------
    def window(self):
        """The dispatches of the measured window, completed."""
        return [d for d in self.dispatches
                if d["phase"] == "window" and "wavs" in d]

    def device_ms(self, span):
        """A span's device time (CUDA events), None off the card."""
        if "ev" not in span:
            return None
        return span["ev"][0].elapsed_time(span["ev"][1])
