"""Probabilistic YIN (pYIN) fundamental-frequency estimation: a copy of the
JAX package's radtts_tpu/data/pyin.py, with the Viterbi in
radtts_tpu_torch/native.

librosa is not available in this environment, so this is a from-scratch
numpy/scipy implementation of the pYIN algorithm (Mauch & Dixon 2014) with
librosa-0.8-compatible parameters/outputs, used by the dataset F0 extractor
(reference: data.py:244-256 calls librosa.pyin with frame_length=1024,
win_length=frame_length//2, hop_length=256).

Returns (f0, voiced_flag, voiced_prob) per frame like librosa.pyin.
"""

import numpy as np
import scipy.signal
import scipy.stats


def _frame(y, frame_length, hop_length):
    n_frames = 1 + (len(y) - frame_length) // hop_length
    idx = (np.arange(n_frames)[:, None] * hop_length
           + np.arange(frame_length)[None, :])
    return y[idx]  # (n_frames, frame_length)


def _cmnd(y_frames, frame_length, win_length, min_period, max_period):
    """Cumulative mean normalized difference function d'(tau),
    tau in [min_period, max_period]. y_frames: (n_frames, frame_length)."""
    # autocorrelation via FFT: acf[tau] = sum_j y[j] y[j+tau], j < win_length
    a = np.fft.rfft(y_frames, frame_length, axis=1)
    b = np.fft.rfft(y_frames[:, win_length::-1], frame_length, axis=1)
    acf = np.fft.irfft(a * b, frame_length, axis=1)[:, win_length:]
    acf[np.abs(acf) < 1e-6] = 0

    energy = np.cumsum(y_frames ** 2, axis=1)
    energy = energy[:, win_length:] - energy[:, :-win_length]
    energy[np.abs(energy) < 1e-6] = 0

    yin = energy[:, :1] + energy - 2 * acf  # d(tau), tau in [0, fl-wl]

    tau_range = np.arange(1, max_period + 1)[None, :]
    cumulative_mean = (np.cumsum(yin[:, 1:max_period + 1], axis=1)
                       / tau_range)
    yin_num = yin[:, min_period:max_period + 1]
    yin_den = cumulative_mean[:, min_period - 1:max_period]
    tiny = np.finfo(yin_den.dtype).tiny
    return yin_num / (yin_den + tiny)


def _parabolic_shifts(yin):
    """Per-lag parabolic interpolation offsets, (n_frames, n_lags)."""
    shifts = np.zeros_like(yin)
    a = (yin[:, :-2] + yin[:, 2:] - 2 * yin[:, 1:-1]) / 2
    b = (yin[:, 2:] - yin[:, :-2]) / 2
    tiny = np.finfo(yin.dtype).tiny
    shifts[:, 1:-1] = -b / (2 * a + tiny)
    shifts[np.abs(shifts) > 1] = 0
    return shifts


def _localmin(x):
    """Boolean local-minimum mask along axis 1 (librosa.util.localmin
    semantics: x[i-1] > x[i] <= x[i+1]; first column compares only right)."""
    mask = np.zeros_like(x, dtype=bool)
    mask[:, 1:-1] = (x[:, :-2] > x[:, 1:-1]) & (x[:, 1:-1] <= x[:, 2:])
    mask[:, 0] = x[:, 0] < x[:, 1]
    return mask


def _transition_local(n_states, width):
    """Row-normalized banded triangular transition matrix (librosa
    sequence.transition_local with a triangle window, wrap=False)."""
    trans = np.zeros((n_states, n_states))
    win = scipy.signal.windows.triang(width)
    half = width // 2
    for i in range(n_states):
        lo = max(0, i - half)
        hi = min(n_states, i + half + 1)
        w_lo = half - (i - lo)
        w_hi = w_lo + (hi - lo)
        trans[i, lo:hi] = win[w_lo:w_hi]
        trans[i] /= trans[i].sum()
    return trans


def _viterbi_log(log_obs, log_trans, log_p_init):
    """Standard Viterbi in log space. log_obs: (T, S); log_trans: (S, S).

    Dispatches to the C++ kernel in radtts_tpu_torch.native when buildable
    (~12x faster at pYIN's state count); this numpy loop is the exact
    fallback and the correctness oracle for the native path."""
    from radtts_tpu_torch.native import viterbi_log_native
    states = viterbi_log_native(log_obs, log_trans, log_p_init)
    if states is not None:
        return states
    T, S = log_obs.shape
    delta = log_p_init + log_obs[0]
    psi = np.zeros((T, S), dtype=np.int32)
    for t in range(1, T):
        scores = delta[:, None] + log_trans  # (S_prev, S_next)
        psi[t] = np.argmax(scores, axis=0)
        delta = scores[psi[t], np.arange(S)] + log_obs[t]
    states = np.zeros(T, dtype=np.int32)
    states[-1] = int(np.argmax(delta))
    for t in range(T - 2, -1, -1):
        states[t] = psi[t + 1][states[t + 1]]
    return states


def _trough_probs(yin, trough_mask, thresholds, beta_probs,
                  boltzmann_parameter, no_trough_prob):
    """Per-(frame, trough) pitch-candidate probabilities, vectorized over
    frames (librosa's per-frame loop costs ~0.17 s per 7 s utterance from
    599 scipy boltzmann.pmf calls; this is one padded einsum-style pass).

    Semantics per frame (identical to librosa.pyin's loop): for each of the
    100 thresholds, troughs below it get a Boltzmann prior over their rank;
    priors dot the beta threshold weights; the globally deepest trough
    absorbs `no_trough_prob` of the beta mass of thresholds it exceeds."""
    n_frames = yin.shape[0]
    yin_probs = np.zeros_like(yin)
    fi, lag = np.nonzero(trough_mask)  # row-major => ascending lag per frame
    if fi.size == 0:
        return yin_probs
    counts = np.bincount(fi, minlength=n_frames)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(fi.size) - starts[fi]  # position within its frame
    max_t = int(counts.max())

    heights = np.full((n_frames, max_t), np.inf)
    heights[fi, rank] = yin[fi, lag]

    # below[f, m, j] = trough m of frame f is below threshold j+1
    below = heights[:, :, None] < thresholds[None, None, 1:]
    pos = (np.cumsum(below, axis=1, dtype=np.int32) - 1)  # rank among below
    n_below = below.sum(axis=1, dtype=np.int32)           # (n_frames, n_thr)

    # scipy.stats.boltzmann.pmf(k, lam, N), same expression/order:
    # (1-exp(-lam)) * exp(-lam*k) / (1-exp(-lam*N)), 0 outside support.
    # pos/n_below are small ints, so the exps become table lookups.
    lam = boltzmann_parameter
    exp_tab = np.exp(-lam * np.arange(max_t + 1, dtype=np.float64))
    num_tab = (1.0 - np.exp(-lam)) * exp_tab    # (1-e^-lam) e^{-lam k}
    denom_tab = 1.0 - exp_tab                   # 1 - e^{-lam N}; 0 at N=0
    with np.errstate(divide="ignore", invalid="ignore"):
        prior = num_tab[np.maximum(pos, 0)] / denom_tab[n_below][:, None, :]
    prior[~below] = 0.0

    probs = prior @ beta_probs                  # (n_frames, max_t)

    # deepest trough absorbs no_trough_prob of the thresholds it exceeds
    has = counts > 0
    gmin = np.argmin(heights, axis=1)
    n_thr_above_min = (~below[np.arange(n_frames), gmin, :]).sum(axis=1)
    # np.sum prefix table (pairwise summation, bitwise-equal to the
    # per-frame np.sum(beta_probs[:n]) of the reference loop)
    cum_beta = np.array([beta_probs[:n].sum()
                         for n in range(len(beta_probs) + 1)])
    probs[has, gmin[has]] += no_trough_prob * cum_beta[n_thr_above_min[has]]

    yin_probs[fi, lag] = probs[fi, rank]
    return yin_probs


def pyin(y, fmin, fmax, sr=22050, frame_length=2048, win_length=None,
         hop_length=None, n_thresholds=100, beta_parameters=(2, 18),
         boltzmann_parameter=2, resolution=0.1, max_transition_rate=35.92,
         switch_prob=0.01, no_trough_prob=0.01, fill_na=np.nan, center=True):
    """pYIN pitch tracking. y: 1-D float waveform in [-1, 1]."""
    if win_length is None:
        win_length = frame_length // 2
    if hop_length is None:
        hop_length = frame_length // 4
    y = np.asarray(y, dtype=np.float64)
    if center:
        y = np.pad(y, frame_length // 2, mode="reflect")

    frames = _frame(y, frame_length, hop_length)
    n_frames = frames.shape[0]

    min_period = max(int(np.floor(sr / fmax)), 1)
    max_period = min(int(np.ceil(sr / fmin)), frame_length - win_length - 1)

    yin = _cmnd(frames, frame_length, win_length, min_period, max_period)
    shifts = _parabolic_shifts(yin)

    thresholds = np.linspace(0, 1, n_thresholds + 1)
    beta_cdf = scipy.stats.beta.cdf(thresholds, *beta_parameters)
    beta_probs = np.diff(beta_cdf)

    trough_mask = _localmin(yin)
    yin_probs = _trough_probs(yin, trough_mask, thresholds, beta_probs,
                              boltzmann_parameter, no_trough_prob)

    frame_index, yin_period = np.nonzero(yin_probs)
    period_candidates = (min_period + yin_period
                         + shifts[frame_index, yin_period])
    f0_candidates = sr / period_candidates

    n_bins_per_semitone = int(np.ceil(1.0 / resolution))
    n_pitch_bins = int(np.floor(12 * n_bins_per_semitone
                                * np.log2(fmax / fmin))) + 1

    max_semitones_per_frame = round(
        max_transition_rate * 12 * hop_length / sr)
    transition_width = max_semitones_per_frame * n_bins_per_semitone + 1
    local_trans = _transition_local(n_pitch_bins, transition_width)
    transition = np.block(
        [[(1 - switch_prob) * local_trans, switch_prob * local_trans],
         [switch_prob * local_trans, (1 - switch_prob) * local_trans]])

    bin_index = np.clip(
        np.round(n_bins_per_semitone * 12
                 * np.log2(f0_candidates / fmin)).astype(int),
        0, n_pitch_bins - 1)

    observation_probs = np.zeros((n_frames, 2 * n_pitch_bins))
    np.add.at(observation_probs, (frame_index, bin_index),
              yin_probs[frame_index, yin_period])
    voiced_prob = np.clip(
        np.sum(observation_probs[:, :n_pitch_bins], axis=1), 0, 1)
    observation_probs[:, n_pitch_bins:] = ((1 - voiced_prob[:, None])
                                           / n_pitch_bins)

    p_init = np.zeros(2 * n_pitch_bins)
    p_init[n_pitch_bins:] = 1.0 / n_pitch_bins

    eps = np.finfo(np.float64).tiny
    states = _viterbi_log(np.log(observation_probs + eps),
                          np.log(transition + eps), np.log(p_init + eps))

    freqs = fmin * 2.0 ** (np.arange(n_pitch_bins)
                           / (12 * n_bins_per_semitone))
    f0 = freqs[states % n_pitch_bins]
    voiced_flag = states < n_pitch_bins
    if fill_na is not None:
        f0 = np.where(voiced_flag, f0, fill_na)
    return f0, voiced_flag, voiced_prob
