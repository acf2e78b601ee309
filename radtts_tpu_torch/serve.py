"""Warm-model TTS serving daemon of the PyTorch port: the repository's
serve.py (same flags, routes and request JSON) on one CUDA device (or the
CPU with --device cpu), or with --data_parallel N on N replicas, one on
each of the first N CUDA devices, that split each synthesize call's batch
(inference.py). The model loads once; each HTTP request is served off it.

    python -m radtts_tpu_torch.serve -c CONFIG -r RADTTS_CKPT \\
        -v HIFIGAN_CKPT -k HIFIGAN_CONFIG -s SPEAKER [--port 8008] \\
        [--batch_wait_ms 5] [--warm] [--data_parallel 2] [--device cpu]

API (stdlib http.server):
  GET  /healthz         -> {"ok": true, "model": ..., "requests": N,
                            "warm": ..., ["batched_dispatches": N]}
  POST /tts   body JSON -> audio/wav bytes (single "text"), or
                           {"sample_rate", "wavs": [b64...], "n_frames"}
                           when given a "texts" list (one batch).
    {"text": "Hello." | "texts": [...], "speaker": "ljs",
     "sigma": 0.8, "sigma_tkndur": 0.666, "sigma_f0": 1.0,
     "sigma_energy": 1.0, "denoising_strength": 0.0, "normalize": true,
     "long_text_chunk": 0, "chunk_gap_ms": 120.0, "stream": false}

A single "text" with "long_text_chunk" > 0 is split at sentence boundaries
and synthesized as one batch, the chunks joined with chunk_gap_ms of
silence (Synthesizer.synthesize_long). With "stream": true the WAV goes
out over HTTP chunked transfer: the first chunk is synthesized alone, the
rest as one batch (normalisation is then per chunk). With --batch_wait_ms
> 0, concurrent single-text requests that share speaker and knobs ride one
synthesize call (MicroBatcher). Single texts pad to the batch path's
16-token buckets (padded == exact).

--matmul_precision and the flags the port cannot honour are handled as by
the inference CLI (radtts_tpu_torch/inference.py); --aot_dir has no
effect.
"""

import argparse
import base64
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from radtts_tpu_torch.config import update_params
from radtts_tpu_torch.inference import add_port_flags, refuse_unsupported
from radtts_tpu_torch.text.chunking import split_text_to_chunks


class MicroBatcher:
    """Aggregate concurrent single-text requests into one synthesize call.

    Requests that share a dispatch key (speaker + knobs, which are
    batch-level) and arrive within `wait_ms` of each other ride ONE
    Synthesizer.synthesize() call of up to `max_batch` texts; padded
    batches equal per-request results, so grouping changes no output.
    A daemon thread runs the dispatch loop until close()."""

    def __init__(self, synth, lock, max_batch=8, wait_ms=5.0):
        self.synth, self.lock = synth, lock
        self.max_batch, self.wait_s = max_batch, wait_ms / 1000.0
        self._cv = threading.Condition()
        self._pending = []  # (key, text, knobs, speaker, box)
        self._closed = False
        self.dispatches = 0
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def synthesize_one(self, key, text, knobs, speaker):
        box = {"ev": threading.Event()}
        with self._cv:
            self._pending.append((key, text, knobs, speaker, box))
            self._cv.notify()
        box["ev"].wait()
        if "err" in box:
            raise box["err"]
        return box["wav"]

    def close(self, timeout=10.0):
        """Stop the dispatch loop once the pending requests are served."""
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._thread.join(timeout)

    def _run(self):
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait()
                if not self._pending:
                    return
            time.sleep(self.wait_s)  # let the burst arrive
            with self._cv:
                key0 = self._pending[0][0]
                take, rest = [], []
                for e in self._pending:
                    if e[0] == key0 and len(take) < self.max_batch:
                        take.append(e)
                    else:
                        rest.append(e)
                self._pending = rest
            texts = [e[1] for e in take]
            knobs, speaker = take[0][2], take[0][3]
            try:
                with self.lock:
                    wavs, _ = self.synth.synthesize(texts, speaker, **knobs)
                    self.dispatches += 1
                for e, w in zip(take, wavs):
                    e[4]["wav"] = w
            except Exception as exc:
                for e in take:
                    e[4]["err"] = exc
            for e in take:
                e[4]["ev"].set()


def _streaming_wav_header(sr):
    """44-byte IEEE-float mono WAV header with 0xFFFFFFFF sizes, the
    convention for streams whose length is unknown up front (players read
    until EOF)."""
    import struct
    return (b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVEfmt "
            + struct.pack("<IHHIIHH", 16, 3, 1, sr, sr * 4, 4, 32)
            + b"data" + struct.pack("<I", 0xFFFFFFFF))


def make_handler(synth, state, defaults, lock, batcher=None):
    from scipy.io.wavfile import write as wav_write

    def render_wav(wav, normalize):
        if normalize:
            peak = float(np.max(np.abs(wav)))
            if peak > 0:
                wav = wav / peak
        buf = io.BytesIO()
        wav_write(buf, synth.sampling_rate, wav.astype(np.float32))
        return buf.getvalue()

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route through one logger
            print(f"[serve] {fmt % args}", flush=True)

        def _reply(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply_json(self, code, obj):
            self._reply(code, json.dumps(obj).encode())

        def _stream_long(self, text, speaker, max_tokens, gap_ms, knobs,
                         normalize):
            """Stream a long text as WAV over HTTP chunked transfer: the
            first sentence chunk synthesizes alone, the rest as one batch.
            Normalisation is per chunk. Once the headers are sent an error
            can only end the stream: it is logged, not replied."""
            parts = ([text] if max_tokens <= 0 else split_text_to_chunks(
                text, lambda s: len(synth.encode(s)), max_tokens))
            sr = synth.sampling_rate
            gap = np.zeros(int(sr * gap_ms / 1000.0), np.float32)

            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def emit(b):
                if b:
                    self.wfile.write(f"{len(b):X}\r\n".encode() + b
                                     + b"\r\n")

            def pcm(w):
                if normalize:
                    peak = float(np.max(np.abs(w)))
                    if peak > 0:
                        w = w / peak
                return np.asarray(w, np.float32).astype("<f4").tobytes()

            try:
                emit(_streaming_wav_header(sr))
                tic = time.perf_counter()
                with lock:
                    first, _ = synth.synthesize(parts[0], speaker, **knobs)
                    state["requests"] += 1
                emit(pcm(first[0]))
                ttfa = time.perf_counter() - tic
                if len(parts) > 1:
                    emit(gap.tobytes())
                    with lock:
                        rest, _ = synth.synthesize(parts[1:], speaker,
                                                   **knobs)
                    for j, w in enumerate(rest):
                        emit(pcm(w))
                        if j < len(rest) - 1:
                            emit(gap.tobytes())
                self.wfile.write(b"0\r\n\r\n")
                print(f"[serve] streamed {len(parts)} chunk(s), "
                      f"first audio after {ttfa:.3f}s", flush=True)
            except Exception as exc:
                print(f"[serve] stream aborted: {exc!r}", flush=True)
                try:
                    self.wfile.write(b"0\r\n\r\n")
                except OSError:
                    pass

        def do_GET(self):
            if self.path in ("/healthz", "/"):
                extra = ({"batched_dispatches": batcher.dispatches}
                         if batcher is not None else {})
                self._reply_json(200, {"ok": True, **state, **extra})
            else:
                self._reply_json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path != "/tts":
                self._reply_json(404, {"error": f"no route {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                texts = req.get("texts")
                single = texts is None
                if single:
                    texts = [req["text"]]
                knobs = {k: float(req.get(k, defaults[k]))
                         for k in ("sigma", "sigma_tkndur", "sigma_f0",
                                   "sigma_energy", "denoising_strength")}
                speaker = req.get("speaker", defaults["speaker"])
                normalize = bool(req.get("normalize", True))
                chunk_tokens = int(req.get("long_text_chunk",
                                           defaults["long_text_chunk"]))
                gap_ms = float(req.get("chunk_gap_ms",
                                       defaults["chunk_gap_ms"]))
            except Exception as exc:
                self._reply_json(400, {"error": repr(exc)})
                return
            if bool(req.get("stream", False)) and single:
                self._stream_long(texts[0], speaker, chunk_tokens, gap_ms,
                                  knobs, normalize)
                return
            try:
                tic = time.perf_counter()
                aux = None
                if batcher is not None and single and chunk_tokens <= 0:
                    # concurrent same-key singles share one synthesize call
                    key = (speaker, tuple(sorted(knobs.items())))
                    wavs = [batcher.synthesize_one(key, texts[0], knobs,
                                                   speaker)]
                    with lock:
                        state["requests"] += 1
                else:
                    with lock:  # one device pipeline; batch in-request
                        if single and chunk_tokens > 0:
                            wav, aux = synth.synthesize_long(
                                texts[0], speaker, max_tokens=chunk_tokens,
                                gap_ms=gap_ms, **knobs)
                            wavs = [wav]
                        else:
                            wavs, aux = synth.synthesize(texts, speaker,
                                                         **knobs)
                        # inside the lock: handlers run concurrently, and
                        # += on shared state is not atomic
                        state["requests"] += 1
                dt = time.perf_counter() - tic
                audio_s = sum(len(w) for w in wavs) / synth.sampling_rate
                print(f"[serve] {len(texts)} text(s) -> {audio_s:.2f}s "
                      f"audio in {dt:.3f}s "
                      f"(RTF {dt / max(audio_s, 1e-9):.4f})", flush=True)
            except Exception as exc:
                self._reply_json(500, {"error": repr(exc)})
                return
            if single:
                self._reply(200, render_wav(wavs[0], normalize),
                            ctype="audio/wav")
            else:
                self._reply_json(200, {
                    "sample_rate": synth.sampling_rate,
                    "n_frames": aux["n_frames"].tolist(),
                    "wavs": [base64.b64encode(
                        render_wav(w, normalize)).decode() for w in wavs]})

    return Handler


class TTSServer(ThreadingHTTPServer):
    """The HTTP server; server_close() also stops the micro-batcher."""

    batcher = None

    def server_close(self):
        super().server_close()
        if self.batcher is not None:
            self.batcher.close()


def build_parser():
    ap = argparse.ArgumentParser(prog="python -m radtts_tpu_torch.serve")
    ap.add_argument('-c', '--config', type=str, required=True)
    ap.add_argument('-p', '--params', nargs='+', default=[])
    ap.add_argument('-r', '--radtts_path', type=str, required=True)
    ap.add_argument('-v', '--vocoder_path', type=str, required=True)
    ap.add_argument('-k', '--config_vocoder', type=str, required=True)
    ap.add_argument('-s', '--speaker', type=str, required=True,
                    help="default speaker (requests may override)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", default=8008, type=int,
                    help="0 picks a free port")
    ap.add_argument("--sigma", default=0.8, type=float)
    ap.add_argument("--sigma_tkndur", default=0.666, type=float)
    ap.add_argument("--sigma_f0", default=1.0, type=float)
    ap.add_argument("--sigma_energy", default=1.0, type=float)
    ap.add_argument("-d", "--denoising_strength", default=0.0, type=float)
    ap.add_argument("--token_dur_scaling", default=1.0, type=float)
    ap.add_argument("--f0_mean", default=0.0, type=float)
    ap.add_argument("--f0_std", default=0.0, type=float)
    ap.add_argument("--energy_mean", default=0.0, type=float)
    ap.add_argument("--energy_std", default=0.0, type=float)
    ap.add_argument("--long_text_chunk", default=0, type=int,
                    help="default sentence-chunking token budget for "
                         "single-text requests (0 = off)")
    ap.add_argument("--chunk_gap_ms", default=120.0, type=float)
    ap.add_argument("--batch_wait_ms", default=0.0, type=float,
                    help="micro-batching window: concurrent single-text "
                         "requests sharing speaker+knobs within this many "
                         "ms ride one synthesize call (0 = off)")
    ap.add_argument("--max_batch", default=8, type=int,
                    help="micro-batching cap per dispatch")
    ap.add_argument("--seed", default=1234, type=int)
    ap.add_argument("--warm", action="store_true",
                    help="run one short request at startup, before the "
                         "first real one")
    add_port_flags(ap)
    return ap


def build_server(argv=None):
    """Load the model and bind the server (not yet serving) from CLI
    arguments. Returns (server, synth, state); run server.serve_forever(),
    and end with server.shutdown() and server.server_close()."""
    from radtts_tpu_torch.synthesizer import Synthesizer

    ap = build_parser()
    args = ap.parse_args(argv)
    refuse_unsupported(ap, args)
    with open(args.config) as f:
        config = json.load(f)
    update_params(config, args.params)

    synth = Synthesizer(
        config, args.radtts_path, args.vocoder_path, args.config_vocoder,
        seed=args.seed, token_dur_scaling=args.token_dur_scaling,
        f0_mean=args.f0_mean, f0_std=args.f0_std,
        energy_mean=args.energy_mean, energy_std=args.energy_std,
        bucket_single=True, use_amp=args.use_amp,
        weight_dtype=args.weight_dtype,
        matmul_precision=args.matmul_precision,
        data_parallel=args.data_parallel, device=args.device)
    print(f"[serve] loaded '{args.radtts_path}' on "
          f"{', '.join(map(str, synth.devices))}", flush=True)

    defaults = {"sigma": args.sigma, "sigma_tkndur": args.sigma_tkndur,
                "sigma_f0": args.sigma_f0, "sigma_energy": args.sigma_energy,
                "denoising_strength": args.denoising_strength,
                "speaker": args.speaker,
                "long_text_chunk": args.long_text_chunk,
                "chunk_gap_ms": args.chunk_gap_ms}
    state = {"model": args.radtts_path, "requests": 0,
             "warm": not args.warm}
    lock = threading.Lock()
    batcher = (MicroBatcher(synth, lock, max_batch=args.max_batch,
                            wait_ms=args.batch_wait_ms)
               if args.batch_wait_ms > 0 else None)
    server = TTSServer(
        (args.host, args.port),
        make_handler(synth, state, defaults, lock, batcher=batcher))
    server.batcher = batcher

    if args.warm:
        # listening already: /healthz answers ("warm": false) and the
        # first real request queues behind the warm one on the lock
        def warm():
            tic = time.perf_counter()
            with lock:
                synth.synthesize(
                    "Warm up.", args.speaker, sigma=args.sigma,
                    sigma_tkndur=args.sigma_tkndur, sigma_f0=args.sigma_f0,
                    sigma_energy=args.sigma_energy,
                    denoising_strength=args.denoising_strength)
            state["warm"] = True
            print(f"[serve] warm synthesis in "
                  f"{time.perf_counter() - tic:.1f}s", flush=True)

        threading.Thread(target=warm, daemon=True).start()
    host, port = server.server_address[:2]
    print(f"[serve] listening on http://{host}:{port}", flush=True)
    return server, synth, state


def main(argv=None):
    server, _, _ = build_server(argv)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
