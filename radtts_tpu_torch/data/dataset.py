"""The RADTTS dataset, collate and loader of the training data pipeline: a
copy of the JAX package's radtts_tpu/data/dataset.py (its Data, DataCollate,
DataLoader and data_factory), all numpy on the host, so that a batch is the
JAX package's bit for bit:

  * features as numpy arrays (mel (T, n_mel) channels-last);
  * the collate pads to bucketed shapes (text and frames rounded up to
    multiples of 16);
  * deterministic shuffling from the seed and rank sharding;
  * the same on-disk caches as the reference: beta-binomial priors keyed by
    (n_tokens, n_frames), pyin F0 keyed by audio and stft settings.

Serving uses only the text and speaker part (the speaker ids a checkpoint
was trained with, and the text frontend its config names). The cache
directory is made at the first write, not when a Data is built.

LMDB read-through caches are supported when the lmdb module is installed
(reference: data.py:150-176); otherwise those config fields must be empty.
"""

import os
import pickle
import threading

import numpy as np
from scipy.io import wavfile

from radtts_tpu_torch.data.audio_np import mel_spectrogram_np
from radtts_tpu_torch.data.pyin import pyin
from radtts_tpu_torch.text.processing import TextProcessing, resolve_asset

try:
    import lmdb
except ImportError:  # pragma: no cover - optional
    lmdb = None


def beta_binomial_prior_distribution(phoneme_count, mel_count,
                                     scaling_factor=0.05):
    """(reference: data.py:58-69) (mel_count, phoneme_count) prior.

    The reference builds one scipy frozen `betabinom(P-1, a_i, b_i)` PER
    MEL FRAME (a_i = s*i, b_i = s*(M+1-i)) — ~1.7 s per new (P, M) shape,
    almost all of it scipy distribution-construction overhead, and the
    disk cache rarely hits because most clips have a unique shape. Same
    pmf evaluated in closed form over the whole (M, P) grid at once:

      log pmf(k; n, a, b) = log C(n, k) + betaln(k+a, n-k+b) - betaln(a, b)

    — two gammaln broadcasts, ~1 ms. Matches scipy to float64 rounding
    (test_beta_binomial_prior_matches_reference)."""
    from scipy.special import betaln, gammaln

    P, M = phoneme_count, mel_count
    n = P - 1
    k = np.arange(P, dtype=np.float64)[None, :]              # (1, P)
    i = np.arange(1, M + 1, dtype=np.float64)[:, None]       # (M, 1)
    a = scaling_factor * i
    b = scaling_factor * (M + 1 - i)
    log_binom = (gammaln(n + 1) - gammaln(k + 1) - gammaln(n - k + 1))
    logp = log_binom + betaln(k + a, n - k + b) - betaln(a, b)
    return np.exp(logp).astype(np.float32)


def load_wav(full_path):
    sampling_rate, data = wavfile.read(full_path)
    return np.asarray(data, dtype=np.float32), sampling_rate


class Data:
    def __init__(self, datasets, filter_length, hop_length, win_length,
                 sampling_rate, n_mel_channels, mel_fmin, mel_fmax, f0_min,
                 f0_max, max_wav_value, use_f0, use_energy_avg, use_log_f0,
                 use_scaled_energy, symbol_set, cleaner_names,
                 heteronyms_path, phoneme_dict_path, p_phoneme,
                 handle_phoneme="word", handle_phoneme_ambiguous="ignore",
                 speaker_ids=None, include_speakers=None, n_frames=-1,
                 use_attn_prior_masking=True, prepend_space_to_text=True,
                 append_space_to_text=True, add_bos_eos_to_text=False,
                 betabinom_cache_path="", betabinom_scaling_factor=0.05,
                 lmdb_cache_path="", dur_min=None, dur_max=None,
                 combine_speaker_and_emotion=False, **kwargs):
        self.combine_speaker_and_emotion = combine_speaker_and_emotion
        self.max_wav_value = max_wav_value
        self.audio_lmdb_dict = {}
        self.data = self.load_data(datasets)
        self.distance_tx_unvoiced = kwargs.get("distance_tx_unvoiced", False)
        self.stft_kwargs = dict(filter_length=filter_length,
                                hop_length=hop_length,
                                win_length=win_length,
                                sampling_rate=sampling_rate,
                                n_mel_channels=n_mel_channels,
                                mel_fmin=mel_fmin, mel_fmax=mel_fmax)
        self.do_mel_scaling = kwargs.get("do_mel_scaling", True)
        self.mel_noise_scale = kwargs.get("mel_noise_scale", 0.0)
        self.filter_length = filter_length
        self.hop_length = hop_length
        self.win_length = win_length
        self.f0_min = f0_min
        self.f0_max = f0_max
        self.use_f0 = use_f0
        self.use_log_f0 = use_log_f0
        self.use_energy_avg = use_energy_avg
        self.use_scaled_energy = use_scaled_energy
        self.sampling_rate = sampling_rate
        self.tp = TextProcessing(
            symbol_set, cleaner_names, heteronyms_path, phoneme_dict_path,
            p_phoneme=p_phoneme, handle_phoneme=handle_phoneme,
            handle_phoneme_ambiguous=handle_phoneme_ambiguous,
            prepend_space_to_text=prepend_space_to_text,
            append_space_to_text=append_space_to_text,
            add_bos_eos_to_text=add_bos_eos_to_text)

        self.dur_min = dur_min
        self.dur_max = dur_max
        if speaker_ids is None or speaker_ids == "":
            self.speaker_ids = self.create_speaker_lookup_table(self.data)
        else:
            self.speaker_ids = speaker_ids

        print("Number of files", len(self.data))
        if include_speakers is not None:
            for (speaker_set, include) in include_speakers:
                self.filter_by_speakers_(speaker_set, include)
            print("Number of files after speaker filtering", len(self.data))
        if dur_min is not None and dur_max is not None:
            self.filter_by_duration_(dur_min, dur_max)
            print("Number of files after duration filtering", len(self.data))

        self.use_attn_prior_masking = bool(use_attn_prior_masking)
        self.betabinom_cache_path = betabinom_cache_path
        self.betabinom_scaling_factor = betabinom_scaling_factor
        self.lmdb_cache_path = lmdb_cache_path
        if self.lmdb_cache_path:
            if lmdb is None:
                raise RuntimeError("lmdb_cache_path set but lmdb module is "
                                   "not available")
            self.cache_data_lmdb = lmdb.open(
                self.lmdb_cache_path, readonly=True, max_readers=1024,
                lock=False).begin()

        self.speaker_map = kwargs.get("speaker_map")

    # ------------------------------------------------------------------

    def load_data(self, datasets, split="|"):
        dataset = []
        for dset_name, dset_dict in datasets.items():
            folder_path = dset_dict["basedir"]
            audiodir = dset_dict["audiodir"]
            filename = dset_dict["filelist"]
            audio_lmdb_key = None
            if dset_dict.get("lmdbpath"):
                if lmdb is None:
                    raise RuntimeError("filelist lmdbpath set but lmdb "
                                       "module is not available")
                self.audio_lmdb_dict[dset_name] = lmdb.open(
                    dset_dict["lmdbpath"], readonly=True, max_readers=256,
                    lock=False).begin()
                audio_lmdb_key = dset_name

            wav_folder_prefix = os.path.join(folder_path, audiodir)
            filelist_path = resolve_asset(os.path.join(folder_path,
                                                       filename))
            with open(filelist_path, encoding="utf-8") as f:
                rows = [line.strip().split(split) for line in f]
            for d in rows:
                emotion = "other" if len(d) == 3 else d[3]
                duration = -1 if len(d) == 3 else d[4]
                speaker = (d[2] + "-" + emotion
                           if self.combine_speaker_and_emotion else d[2])
                dataset.append({
                    "audiopath": os.path.join(wav_folder_prefix, d[0]),
                    "text": d[1],
                    "speaker": speaker,
                    "emotion": emotion,
                    "duration": float(duration),
                    "lmdb_key": audio_lmdb_key,
                })
        return dataset

    def filter_by_speakers_(self, speakers, include=True):
        if include:
            self.data = [x for x in self.data if x["speaker"] in speakers]
        else:
            self.data = [x for x in self.data
                         if x["speaker"] not in speakers]

    def filter_by_duration_(self, dur_min, dur_max):
        self.data = [x for x in self.data
                     if x["duration"] == -1
                     or dur_min <= x["duration"] <= dur_max]

    def create_speaker_lookup_table(self, data):
        speaker_ids = np.sort(np.unique([x["speaker"] for x in data]))
        d = {speaker_ids[i]: i for i in range(len(speaker_ids))}
        print("Number of speakers:", len(d))
        return d

    # ------------------------------------------------------------------

    def f0_normalize(self, x):
        if self.use_log_f0:
            mask = x >= self.f0_min
            x = np.where(mask, np.log(np.maximum(x, 1e-10)), 0.0)
        return x

    def energy_avg_normalize(self, x):
        if self.use_scaled_energy:
            x = (x + 20.0) / 20.0
        return x

    def get_f0_pvoiced(self, audio):
        audio_norm = audio / self.max_wav_value
        f0, voiced_mask, p_voiced = pyin(
            audio_norm, self.f0_min, self.f0_max, self.sampling_rate,
            frame_length=self.filter_length,
            win_length=self.filter_length // 2,
            hop_length=self.hop_length)
        f0 = np.where(voiced_mask, f0, 0.0).astype(np.float32)
        return (f0, voiced_mask.astype(np.float32),
                p_voiced.astype(np.float32))

    def get_energy_average(self, mel):
        # mel: (T, n_mel); average over mel channels per frame
        return self.energy_avg_normalize(mel.mean(axis=1))

    def get_mel(self, audio):
        audio_norm = audio / self.max_wav_value
        mel = mel_spectrogram_np(audio_norm, **{
            k: v for k, v in self.stft_kwargs.items()})
        if self.do_mel_scaling:
            mel = (mel + 5.5) / 2
        if self.mel_noise_scale > 0:
            mel = mel + np.random.randn(*mel.shape).astype(
                np.float32) * self.mel_noise_scale
        return mel  # (T, n_mel)

    def get_speaker_id(self, speaker):
        if self.speaker_map is not None and speaker in self.speaker_map:
            speaker = self.speaker_map[speaker]
        return np.int64(self.speaker_ids[speaker])

    def get_text(self, text):
        return np.asarray(self.tp.encode_text(text), dtype=np.int64)

    def get_attention_prior(self, n_tokens, n_frames):
        if not self.use_attn_prior_masking:
            return None
        filename = "{}_{}".format(n_tokens, n_frames)
        if self.betabinom_cache_path:
            prior_path = os.path.join(self.betabinom_cache_path,
                                      filename + "_prior.npy")
            if self.lmdb_cache_path:
                return pickle.loads(self.cache_data_lmdb.get(
                    prior_path.encode("ascii")))
            if os.path.exists(prior_path):
                return np.load(prior_path)
            prior = beta_binomial_prior_distribution(
                n_tokens, n_frames, self.betabinom_scaling_factor)
            _write_cache(prior_path, np.save, prior)
            return prior
        return beta_binomial_prior_distribution(
            n_tokens, n_frames, self.betabinom_scaling_factor)

    # ------------------------------------------------------------------

    def __getitem__(self, index):
        data = self.data[index]
        audiopath, text = data["audiopath"], data["text"]

        if data["lmdb_key"] is not None:
            data_dict = pickle.loads(
                self.audio_lmdb_dict[data["lmdb_key"]].get(
                    audiopath.encode("ascii")))
            audio = data_dict["audio"]
            sampling_rate = data_dict["sampling_rate"]
        else:
            audio, sampling_rate = load_wav(audiopath)
        if sampling_rate != self.sampling_rate:
            raise ValueError("{} SR doesn't match target {} SR".format(
                sampling_rate, self.sampling_rate))

        mel = self.get_mel(audio)
        f0 = p_voiced = voiced_mask = None
        if self.use_f0:
            filename = "_".join(audiopath.split("/")[-3:])
            f0_path = os.path.join(self.betabinom_cache_path, filename)
            f0_path += ("_f0_sr{}_fl{}_hl{}_f0min{}_f0max{}_log{}.npz"
                        .format(self.sampling_rate, self.filter_length,
                                self.hop_length, self.f0_min, self.f0_max,
                                self.use_log_f0))
            dikt = None
            if self.lmdb_cache_path:
                dikt = pickle.loads(self.cache_data_lmdb.get(
                    f0_path.encode("ascii")))
            elif os.path.exists(f0_path):
                try:
                    dikt = dict(np.load(f0_path))
                except Exception:
                    print(f"f0 cache {f0_path} is broken, recomputing.")
            if dikt is not None:
                f0 = dikt["f0"]
                p_voiced = dikt["p_voiced"]
                voiced_mask = dikt["voiced_mask"]
            else:
                f0, voiced_mask, p_voiced = self.get_f0_pvoiced(audio)
                _write_cache(f0_path, np.savez, f0=f0,
                             voiced_mask=voiced_mask, p_voiced=p_voiced)
            f0 = self.f0_normalize(np.asarray(f0, dtype=np.float32))
            if self.distance_tx_unvoiced:
                from scipy.ndimage import distance_transform_edt
                mask = f0 <= 0.0
                dist = np.log(np.maximum(distance_transform_edt(mask),
                                         1e-10))
                dist[dist <= 0] = 0.0
                f0 = f0 - dist

        energy_avg = None
        if self.use_energy_avg:
            energy_avg = self.get_energy_average(mel)
            if self.use_scaled_energy and energy_avg.min() < 0.0:
                print(audiopath, "has scaled energy avg smaller than 0")

        speaker_id = self.get_speaker_id(data["speaker"])
        text_encoded = self.get_text(text)
        attn_prior = self.get_attention_prior(len(text_encoded),
                                              mel.shape[0])
        return {"mel": mel, "speaker_id": speaker_id,
                "text_encoded": text_encoded, "audiopath": audiopath,
                "attn_prior": attn_prior, "f0": f0, "p_voiced": p_voiced,
                "voiced_mask": voiced_mask, "energy_avg": energy_avg}

    def __len__(self):
        return len(self.data)


def _round_up(x, m):
    return ((x + m - 1) // m) * m


class DataCollate:
    """Pad a list of samples into one batch with bucketed static shapes.

    text_pad_multiple / frame_pad_multiple bound the number of distinct
    (N, T) shape pairs XLA must compile; frame_pad_multiple must be a
    multiple of every n_group_size in the model config (default 16 covers
    group sizes 1/2/4/8)."""

    def __init__(self, n_frames_per_step=1, text_pad_multiple=16,
                 frame_pad_multiple=16):
        self.text_pad_multiple = text_pad_multiple
        self.frame_pad_multiple = frame_pad_multiple

    def __call__(self, batch):
        lengths = np.asarray([len(x["text_encoded"]) for x in batch])
        order = np.argsort(-lengths)  # sort desc by text length
        batch = [batch[i] for i in order]
        input_lengths = lengths[order]

        B = len(batch)
        max_input_len = _round_up(int(input_lengths[0]),
                                  self.text_pad_multiple)
        max_target_len = _round_up(
            max(x["mel"].shape[0] for x in batch), self.frame_pad_multiple)
        n_mel = batch[0]["mel"].shape[1]

        text_padded = np.zeros((B, max_input_len), dtype=np.int64)
        mel_padded = np.zeros((B, max_target_len, n_mel), dtype=np.float32)
        output_lengths = np.zeros((B,), dtype=np.int64)
        speaker_ids = np.zeros((B,), dtype=np.int64)
        audiopaths = []

        def _opt(key):
            if batch[0][key] is None:
                return None
            return np.zeros((B, max_target_len), dtype=np.float32)

        f0_padded = _opt("f0")
        p_voiced_padded = _opt("p_voiced")
        voiced_mask_padded = _opt("voiced_mask")
        energy_avg_padded = _opt("energy_avg")
        attn_prior_padded = (
            np.zeros((B, max_target_len, max_input_len), dtype=np.float32)
            if batch[0]["attn_prior"] is not None else None)

        for i, sample in enumerate(batch):
            text = sample["text_encoded"]
            text_padded[i, : len(text)] = text
            mel = sample["mel"]
            mel_padded[i, : mel.shape[0]] = mel
            output_lengths[i] = mel.shape[0]
            speaker_ids[i] = sample["speaker_id"]
            audiopaths.append(sample["audiopath"])
            for arr, key in ((f0_padded, "f0"),
                             (p_voiced_padded, "p_voiced"),
                             (voiced_mask_padded, "voiced_mask"),
                             (energy_avg_padded, "energy_avg")):
                if arr is not None and sample[key] is not None:
                    v = sample[key]
                    arr[i, : len(v)] = v
            if attn_prior_padded is not None:
                pr = sample["attn_prior"]
                attn_prior_padded[i, : pr.shape[0], : pr.shape[1]] = pr

        return {"mel": mel_padded, "speaker_ids": speaker_ids,
                "text": text_padded,
                "input_lengths": input_lengths.astype(np.int64),
                "output_lengths": output_lengths,
                "audiopaths": audiopaths,
                "attn_prior": attn_prior_padded, "f0": f0_padded,
                "p_voiced": p_voiced_padded,
                "voiced_mask": voiced_mask_padded,
                "energy_avg": energy_avg_padded}


_WORKER_DATASET = None


def _pool_init(factory, factory_args):
    """Each worker process builds its own dataset (LMDB handles/file
    objects do not survive spawn+pickle)."""
    global _WORKER_DATASET
    _WORKER_DATASET = factory(*factory_args)


def _pool_get(i):
    return _WORKER_DATASET[int(i)]


def data_factory(data_config, files_key, speaker_ids=None):
    """Picklable Data factory for DataLoader worker processes."""
    ignore_keys = ("training_files", "validation_files")
    return Data(data_config[files_key],
                **{k: v for k, v in data_config.items()
                   if k not in ignore_keys},
                speaker_ids=speaker_ids)


def _write_cache(path, save, *args, **kwargs):
    """save(file, ...) to a temporary file beside path, then renamed onto
    it: ranks that read one row (the ranks of a model group, every rank's
    validation) each write its cache, and none reads a half-written one."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    with open(tmp, "wb") as f:
        save(f, *args, **kwargs)
    os.replace(tmp, path)


class DataLoader:
    """Minimal prefetching loader with deterministic per-epoch shuffling
    and rank sharding (replaces torch DataLoader + DistributedSampler;
    reference: train.py:147-156).

    Default: a thread pool collates batches — fine once the pyin/prior
    caches are warm (cache hits are IO-bound). num_worker_procs > 0 adds a
    spawn-based process pool that fetches SAMPLES in parallel — the
    analogue of the reference's 8 worker processes (train.py:151-154) —
    because first-epoch pyin cache misses are GIL-bound numpy. Requires
    worker_init=(factory, args): each worker rebuilds the dataset via
    factory(*args) (see data_factory)."""

    def __init__(self, dataset, batch_size, collate_fn, *, shuffle=True,
                 seed=0, rank=0, world_size=1, num_workers=4,
                 drop_last=True, num_worker_procs=0, worker_init=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.seed = seed
        self.rank = rank
        self.world_size = world_size
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.epoch = 0
        self.num_worker_procs = num_worker_procs
        self.worker_init = worker_init
        self._pool = None

    def set_epoch(self, epoch):
        self.epoch = epoch

    def _get_pool(self):
        if self._pool is None:
            import multiprocessing as mp
            ctx = mp.get_context("spawn")
            factory, factory_args = self.worker_init
            self._pool = ctx.Pool(self.num_worker_procs, _pool_init,
                                  (factory, factory_args))
        return self._pool

    def close(self):
        if self._pool is not None:
            self._pool.terminate()
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _indices(self):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            idx = rng.permutation(n)
        else:
            idx = np.arange(n)
        if self.world_size > 1:
            # wrap-pad so every rank gets the SAME sample count (torch
            # DistributedSampler semantics, reference train.py:147-149):
            # unequal counts would give ranks different batch counts —
            # one rank then executes a step whose collectives no other
            # rank joins — and different final-batch sizes, which the
            # global-array assembly in trainer.shard_batch cannot accept.
            total = (-n % self.world_size) + n
            if total > n:
                # np.resize repeats cyclically — correct even when the pad
                # exceeds the dataset size (n < world_size), where a single
                # concat slice would still leave ranks with zero samples
                idx = np.resize(idx, total)
        idx = idx[self.rank::self.world_size]
        n_batches = (len(idx) // self.batch_size if self.drop_last
                     else (len(idx) + self.batch_size - 1)
                     // self.batch_size)
        return [idx[i * self.batch_size:(i + 1) * self.batch_size]
                for i in range(n_batches)]

    def __len__(self):
        return len(self._indices())

    def __iter__(self):
        import concurrent.futures
        import queue as queue_mod

        batches = self._indices()

        if self.num_worker_procs > 0 and self.worker_init is not None:
            proc_pool = self._get_pool()

            def load_batch(batch_idx):
                # samples fan out across worker processes; collate here
                items = proc_pool.map(_pool_get,
                                      [int(i) for i in batch_idx])
                return self.collate_fn(items)
        else:
            def load_batch(batch_idx):
                return self.collate_fn([self.dataset[int(i)]
                                        for i in batch_idx])

        with concurrent.futures.ThreadPoolExecutor(
                max_workers=self.num_workers) as pool:
            q = queue_mod.Queue()
            prefetch = min(self.num_workers * 2, len(batches))
            it = iter(batches)
            inflight = 0
            for _ in range(prefetch):
                q.put(pool.submit(load_batch, next(it)))
                inflight += 1
            while inflight:
                fut = q.get()
                inflight -= 1
                try:
                    q.put(pool.submit(load_batch, next(it)))
                    inflight += 1
                except StopIteration:
                    pass
                yield fut.result()
