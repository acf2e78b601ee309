"""radtts_tpu_torch.serve on the CPU: its MicroBatcher and streaming WAV
header (the cases of tests/test_serve_units.py, against the port's
module), and the daemon in-process on port 0, built from checkpoint files
by build_server, answering every route; its WAVs against a from_parts
Synthesizer on the same weights in memory."""

import base64
import io
import json
import struct
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from tests.test_torch_inference_cli import fixtures  # noqa: F401
from tests.test_torch_synthesizer_parity import _audible_vocoder, np_tree

from radtts_tpu_torch.convert import hifigan_from_jax, radtts_from_jax
from radtts_tpu_torch.models.hifigan import denoiser_init
from radtts_tpu_torch.serve import (MicroBatcher, _streaming_wav_header,
                                    build_server)
from radtts_tpu_torch.synthesizer import Synthesizer

TIMEOUT = 120   # seconds, for every request and join


class _FakeSynth:
    """Records synthesize() calls; returns one short wav per text."""

    def __init__(self):
        self.calls = []

    def synthesize(self, texts, speaker, **knobs):
        if isinstance(texts, str):
            texts = [texts]
        self.calls.append((list(texts), speaker, dict(knobs)))
        time.sleep(0.01)
        return [np.full(100 + 10 * j, 0.1, np.float32)
                for j in range(len(texts))], {}


def _join_all(threads):
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads)


def test_microbatcher_groups_same_key():
    synth = _FakeSynth()
    b = MicroBatcher(synth, threading.Lock(), max_batch=8, wait_ms=150)
    knobs = {"sigma": 0.8}
    results = [None] * 4

    def fire(ix):
        results[ix] = b.synthesize_one(("ljs", (("sigma", 0.8),)),
                                       f"text {ix}", knobs, "ljs")

    threads = [threading.Thread(target=fire, args=(ix,)) for ix in range(4)]
    for t in threads:
        t.start()
    _join_all(threads)
    b.close()
    assert all(r is not None for r in results)
    assert b.dispatches == 1, synth.calls
    assert sorted(len(t) for t, _, _ in synth.calls) == [4]
    # each requester got the wav for its text (row order preserved)
    texts_in_call = synth.calls[0][0]
    for ix in range(4):
        row = texts_in_call.index(f"text {ix}")
        assert len(results[ix]) == 100 + 10 * row


def test_microbatcher_separates_keys():
    synth = _FakeSynth()
    b = MicroBatcher(synth, threading.Lock(), max_batch=8, wait_ms=120)
    results = {}

    def fire(name, key):
        results[name] = b.synthesize_one(key, name, {"sigma": 0.5}, key[0])

    threads = [threading.Thread(target=fire, args=(name, key)) for name, key
               in (("a", ("spk1", (("sigma", 0.5),))),
                   ("b", ("spk2", (("sigma", 0.5),))))]
    for t in threads:
        t.start()
    _join_all(threads)
    b.close()
    assert set(results) == {"a", "b"}
    # different keys may not share a dispatch
    assert b.dispatches == 2
    assert all(len(texts) == 1 for texts, _, _ in synth.calls)


def test_microbatcher_propagates_errors():
    class _Boom:
        def synthesize(self, texts, speaker, **knobs):
            raise RuntimeError("boom")

    b = MicroBatcher(_Boom(), threading.Lock(), wait_ms=10)
    with pytest.raises(RuntimeError, match="boom"):
        b.synthesize_one(("s", ()), "t", {}, "s")
    b.close()
    assert not b._thread.is_alive()


def test_streaming_wav_header_fields():
    h = _streaming_wav_header(22050)
    assert len(h) == 44
    assert h[:4] == b"RIFF" and h[8:16] == b"WAVEfmt "
    assert struct.unpack("<I", h[4:8])[0] == 0xFFFFFFFF
    size, fmt, ch, sr, brate, align, bits = struct.unpack("<IHHIIHH",
                                                          h[16:36])
    assert (size, fmt, ch, sr) == (16, 3, 1, 22050)
    assert (brate, align, bits) == (22050 * 4, 4, 32)
    assert h[36:40] == b"data"
    assert struct.unpack("<I", h[40:44])[0] == 0xFFFFFFFF


TEXTS = ["The quick brown fox jumps over the lazy dog.", "Short one!",
         "Middle text, not long."]
LONG = ("It is well known that deep generative models have a rich latent "
        "space. It is possible to synthesize speech with controllable "
        "attributes.")
CHUNK = 40


@pytest.fixture(scope="module")
def served(fixtures):  # noqa: F811
    """The daemon on port 0 in a thread, and a from_parts Synthesizer of
    the same weights; shut down at the end."""
    paths, params, h = fixtures
    server, synth, state = build_server([
        "-c", paths["config"], "-r", paths["radtts"], "-v", paths["vocoder"],
        "-k", paths["vocoder_config"], "-s", "ljs", "--port", "0",
        "--sigma", "0", "--batch_wait_ms", "50", "--seed", "7",
        "--device", "cpu"])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    model = radtts_from_jax(np_tree(params), synth.model_config)
    gen = hifigan_from_jax(np_tree(_audible_vocoder()), h)
    with torch.no_grad():
        den = denoiser_init(gen)
    ref = Synthesizer.from_parts(
        synth.model_config, model, gen, den, encode_fn=synth.encode,
        speaker_id_fn=synth.speaker_id, seed=7, bucket_single=True,
        device="cpu")
    base = "http://%s:%d" % server.server_address[:2]
    try:
        yield base, synth, ref, state
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=TIMEOUT)
        assert not thread.is_alive()


def _get(base, path):
    try:
        with urllib.request.urlopen(base + path, timeout=TIMEOUT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(base, obj, path="/tts"):
    req = urllib.request.Request(
        base + path, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _wav(body):
    sr, audio = wavfile.read(io.BytesIO(body))
    assert sr == 22050 and audio.dtype == np.float32
    return audio


def _normalized(wav):
    return wav / np.abs(wav).max()


def _assert_close(got, want):
    assert got.shape == want.shape
    assert np.isfinite(got).all() and np.abs(want).max() > 0
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_daemon_routes(served):
    base, synth, ref, state = served
    code, health = _get(base, "/healthz")
    assert code == 200 and health["ok"] and health["warm"]
    assert health["batched_dispatches"] == 0
    assert _get(base, "/nope")[0] == 404
    assert _post(base, {}, path="/nope")[0] == 404
    assert _post(base, {"speaker": "ljs"})[0] == 400       # no text

    # one text -> WAV, equal to the in-memory engine's
    code, ctype, body = _post(base, {"text": TEXTS[0]})
    assert code == 200 and ctype == "audio/wav"
    want, _ = ref.synthesize(TEXTS[0], "ljs", sigma=0.0)
    _assert_close(_wav(body), _normalized(want[0]))

    # a batch -> JSON of base64 WAVs
    code, ctype, body = _post(base, {"texts": TEXTS, "normalize": False})
    assert code == 200 and ctype == "application/json"
    out = json.loads(body)
    want, aux = ref.synthesize(TEXTS, "ljs", sigma=0.0)
    assert out["sample_rate"] == 22050
    assert out["n_frames"] == aux["n_frames"].tolist()
    for b64, w in zip(out["wavs"], want):
        _assert_close(_wav(base64.b64decode(b64)), w)

    # a long text in chunks -> one WAV
    code, ctype, body = _post(base, {"text": LONG,
                                     "long_text_chunk": CHUNK})
    assert code == 200 and ctype == "audio/wav"
    want, aux = ref.synthesize_long(LONG, "ljs", max_tokens=CHUNK,
                                    sigma=0.0)
    assert aux["n_chunks"] > 1
    _assert_close(_wav(body), _normalized(want))

    # streamed: the header, then each chunk's PCM with gaps between
    code, ctype, body = _post(base, {"text": LONG, "stream": True,
                                     "long_text_chunk": CHUNK,
                                     "normalize": False})
    assert code == 200 and ctype == "audio/wav"
    assert body[:44] == _streaming_wav_header(22050)
    pcm = np.frombuffer(body[44:], "<f4")
    assert pcm.shape == want.shape
    np.testing.assert_allclose(pcm, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())

    code, health = _get(base, "/healthz")
    assert health["requests"] == state["requests"] == 4   # not the 400


def test_daemon_batches_concurrent_singles(served):
    base, synth, ref, _ = served
    _, before = _get(base, "/healthz")
    barrier = threading.Barrier(len(TEXTS))
    bodies = [None] * len(TEXTS)

    def fire(i):
        barrier.wait(timeout=TIMEOUT)
        bodies[i] = _post(base, {"text": TEXTS[i]})

    threads = [threading.Thread(target=fire, args=(i,))
               for i in range(len(TEXTS))]
    for t in threads:
        t.start()
    _join_all(threads)
    _, after = _get(base, "/healthz")
    dispatches = after["batched_dispatches"] - before["batched_dispatches"]
    assert 1 <= dispatches < len(TEXTS)
    for text, (code, ctype, body) in zip(TEXTS, bodies):
        assert code == 200 and ctype == "audio/wav"
        want, _ = ref.synthesize(text, "ljs", sigma=0.0)
        _assert_close(_wav(body), _normalized(want[0]))
