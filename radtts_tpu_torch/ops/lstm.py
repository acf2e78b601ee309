"""Masked (bi)LSTMs on torch.nn.LSTM with packed sequences: `MaskedLSTM`
(one layer, one or two directions, the norm factorizations) and `LSTM`
(unidirectional, stacked, plain weights, with the carry in and out).

Packed-sequence semantics are what the JAX package reproduces with masked
scans: the forward direction stops at each sequence's length, the backward
direction starts at its last valid frame, and outputs past the length are
zero. Gate order i, f, g, o and the two bias vectors match torch. With
lengths on the card, a run makes three blocking transfers, each a sync
(tracing.py): the lengths' read, packing's copy of the sort order to the
card and unpacking's read of it back.

The recurrent weight is stored as its effective matrix. A spectral-normed
weight is collapsed once at load from its stored power-iteration vectors,
w / (u . (w v)) (`effective_hh`), never through
torch.nn.utils.spectral_norm, whose power iteration would move the weights.

The training form (`factored=True`) holds the recurrent weight as the JAX
package stores it: {sn_w} with the power-iteration vectors sn_u, sn_v as
buffers (sigma = u . (W v) from the detached vectors), {wn_v, wn_g}, or
{w} (`RecurrentWeight`). Its forward calls the LSTM with the effective
weights (torch._VF.lstm, the call nn.LSTM makes, cuDNN on the card), and
`spectral_norm_update` runs the one power iteration per training step.
"""

import warnings

import numpy as np
import torch
from torch import nn
from torch.nn.utils.rnn import (PackedSequence, pack_padded_sequence,
                                pad_packed_sequence)

from radtts_tpu_torch import tracing
from radtts_tpu_torch.ops.masking import sequence_mask


def effective_hh(hh):
    """numpy: collapse a recurrent-weight norm factorization ({w}, {wn_v,
    wn_g} or {sn_w, sn_u, sn_v}) to the effective (4H, H) matrix."""
    if "w" in hh:
        return np.asarray(hh["w"], np.float32)
    if "wn_v" in hh:
        v = np.asarray(hh["wn_v"], np.float32)
        norm = np.sqrt(np.sum(v * v, axis=1, keepdims=True)) + 1e-30
        return np.asarray(hh["wn_g"], np.float32)[:, None] * v / norm
    w = np.asarray(hh["sn_w"], np.float32)
    sigma = np.asarray(hh["sn_u"], np.float32) @ (
        w @ np.asarray(hh["sn_v"], np.float32))
    return w / sigma


# the training form hands cuDNN separate weight tensors, which it copies
# into one buffer at every call; the copy is the point, not a fault
warnings.filterwarnings(
    "ignore", message="RNN module weights are not part of single contiguous")


class RecurrentWeight(nn.Module):
    """One direction's (4H, H) recurrent weight in its training form."""

    def __init__(self, w, norm=None):
        super().__init__()
        self.norm = norm
        w = w.detach().clone()
        if norm == "spectral":
            self.sn_w = nn.Parameter(w)
            u, v = torch.randn(w.shape[0]), torch.randn(w.shape[1])
            self.register_buffer("sn_u", u / (u.norm() + 1e-12))
            self.register_buffer("sn_v", v / (v.norm() + 1e-12))
        elif norm == "weight":
            self.wn_v = nn.Parameter(w)
            self.wn_g = nn.Parameter(w.square().sum(1).sqrt())
        else:
            self.w = nn.Parameter(w)

    def forward(self):
        if self.norm == "spectral":
            sigma = self.sn_u @ (self.sn_w @ self.sn_v)
            return self.sn_w / sigma
        if self.norm == "weight":
            norm = self.wn_v.square().sum(1, keepdim=True).sqrt() + 1e-30
            return self.wn_g[:, None] * self.wn_v / norm
        return self.w

    @torch.no_grad()
    def power_iteration(self):
        w = self.sn_w
        v = w.T @ self.sn_u
        v = v / (v.norm() + 1e-12)
        u = w @ v
        self.sn_u.copy_(u / (u.norm() + 1e-12))
        self.sn_v.copy_(v)

    def numpy_factors(self):
        """The factorization as the JAX package's tree holds it."""
        names = {"spectral": ("sn_w", "sn_u", "sn_v"),
                 "weight": ("wn_v", "wn_g")}.get(self.norm, ("w",))
        return {k: getattr(self, k).detach().cpu().numpy() for k in names}


def spectral_norm_update(model):
    """One power iteration of every spectral-normed recurrent weight in
    model, as the JAX package's spectral_norm_update does before each
    training step's gradient."""
    for m in model.modules():
        if isinstance(m, RecurrentWeight) and m.norm == "spectral":
            m.power_iteration()


def _pack(x, lengths):
    """x (B, T, C) packed by `lengths` (B,), read to the host: packing
    needs them there, each at least 1 (a length-0 item runs one frame, and
    the caller zeroes it)."""
    with tracing.readback("lengths", x.device):
        lens = lengths.detach().to("cpu", torch.int64).clamp(min=1)
    with tracing.upload("lengths", x.device):
        return pack_padded_sequence(x, lens, batch_first=True,
                                    enforce_sorted=False)


class MaskedLSTM(nn.Module):
    """One- or two-directional single-layer LSTM over (B, T, C) with
    optional per-item lengths. Output (B, T, D*H), [fwd ; bwd]."""

    def __init__(self, input_size, hidden_size, bidirectional=True,
                 norm=None, factored=False):
        super().__init__()
        self.lstm = nn.LSTM(input_size, hidden_size, batch_first=True,
                            bidirectional=bidirectional)
        self.norm = norm    # the factorization a checkpoint stores
        self.factored = factored
        if factored:
            # the recurrent weights leave nn.LSTM for their factorization;
            # nn.LSTM keeps w_ih and the biases and is never called
            self.hh = nn.ModuleList(
                RecurrentWeight(self.lstm._parameters.pop(
                    "weight_hh_l0" + sfx), norm)
                for sfx in self.suffixes())
        elif norm == "spectral":
            # a converged spectral norm: largest singular value 1
            with torch.no_grad():
                for name, p in self.lstm.named_parameters():
                    if name.startswith("weight_hh"):
                        p.div_(torch.linalg.matrix_norm(p, ord=2))

    def suffixes(self):
        return ("", "_reverse") if self.lstm.bidirectional else ("",)

    def flat_weights(self):
        """The training form's weights in nn.LSTM's order."""
        out = []
        for sfx, hh in zip(self.suffixes(), self.hh):
            out += [getattr(self.lstm, "weight_ih_l0" + sfx), hh(),
                    getattr(self.lstm, "bias_ih_l0" + sfx),
                    getattr(self.lstm, "bias_hh_l0" + sfx)]
        return out

    def _run(self, x, T):
        """self.lstm(x)[0] of a tensor or a PackedSequence padded to T
        steps, in an `lstm` span. The weights, biases and states follow
        x's dtype (bf16 in an AMP region)."""
        packed = isinstance(x, PackedSequence)
        data = x.data if packed else x
        n_dir = 2 if self.lstm.bidirectional else 1
        with tracing.span("lstm", data.device):
            tracing.count("lstm_steps", T * n_dir)
            if (not self.factored
                    and data.dtype == self.lstm.weight_ih_l0.dtype):
                return self.lstm(x)[0]
            n_batch = int(x.batch_sizes[0]) if packed else x.shape[0]
            h0 = data.new_zeros(n_dir, n_batch, self.lstm.hidden_size)
            weights = [w.to(data.dtype) for w in (
                self.flat_weights() if self.factored
                else self.lstm._flat_weights)]
            if packed:
                out = torch._VF.lstm(data, x.batch_sizes, (h0, h0), weights,
                                     True, 1, 0.0, self.training,
                                     self.lstm.bidirectional)[0]
                return PackedSequence(out, x.batch_sizes, x.sorted_indices,
                                      x.unsorted_indices)
            return torch._VF.lstm(data, (h0, h0), weights, True, 1, 0.0,
                                  self.training, self.lstm.bidirectional,
                                  True)[0]

    def forward(self, x, lengths=None):
        T = x.shape[1]
        if lengths is None:
            return self._run(x, T)
        y = self._run(_pack(x, lengths), T)
        with tracing.readback("lengths", x.device):
            y, _ = pad_packed_sequence(y, batch_first=True, total_length=T)
        return y * sequence_mask(lengths, T).to(y.dtype)[:, :, None]

    @torch.no_grad()
    def folded(self):
        """The inference form: the effective recurrent weights folded in
        numpy as ops/fold_norms.py folds the JAX tree (effective_hh)."""
        if not self.factored:
            return self
        lstm = self.lstm
        out = MaskedLSTM(lstm.input_size, lstm.hidden_size,
                         lstm.bidirectional, self.norm)
        for sfx, hh in zip(self.suffixes(), self.hh):
            for name in ("weight_ih_l0", "bias_ih_l0", "bias_hh_l0"):
                getattr(out.lstm, name + sfx).copy_(
                    getattr(lstm, name + sfx))
            getattr(out.lstm, "weight_hh_l0" + sfx).copy_(torch.from_numpy(
                effective_hh(hh.numpy_factors())))
        return out.to(lstm.weight_ih_l0.device)


class LSTM(nn.Module):
    """Unidirectional LSTM of num_layers over (B, T, C) with plain weights:
    the AGAP's attribute LSTM (one layer) and its stacked decoder LSTM
    (radtts_tpu/ops/lstm.py:65-92, 268-286). forward(x, lengths, carries)
    takes each layer's (h0, c0) (zeros when None) and returns (y, [(h, c)
    per layer]): with lengths, each item's carry stops at its last valid
    frame and y is zero past it (packed sequences, cuDNN on the card)."""

    def __init__(self, input_size, hidden_size, num_layers=1):
        super().__init__()
        self.lstm = nn.LSTM(input_size, hidden_size, num_layers,
                            batch_first=True)

    def forward(self, x, lengths=None, carries=None):
        hx = None
        if carries is not None:
            hx = (torch.stack([h for h, _ in carries]),
                  torch.stack([c for _, c in carries]))
        T = x.shape[1]
        if lengths is None:
            y, (h, c) = self._run(x, hx, T)
        else:
            y, (h, c) = self._run(_pack(x, lengths), hx, T)
            with tracing.readback("lengths", x.device):
                y, _ = pad_packed_sequence(y, batch_first=True,
                                           total_length=T)
            y = y * sequence_mask(lengths, T).to(y.dtype)[:, :, None]
        return y, list(zip(h.unbind(0), c.unbind(0)))

    def _run(self, x, hx, T):
        """self.lstm(x, hx) of a tensor or a PackedSequence padded to T
        steps, in an `lstm` span."""
        data = x.data if isinstance(x, PackedSequence) else x
        with tracing.span("lstm", data.device):
            tracing.count("lstm_steps", T * self.lstm.num_layers)
            return self.lstm(x, hx)

    def weights(self, layer):
        """(w_ih (4H, in), w_hh (4H, H), (b_ih, b_hh)) of one layer."""
        lstm = self.lstm
        return (getattr(lstm, f"weight_ih_l{layer}"),
                getattr(lstm, f"weight_hh_l{layer}"),
                (getattr(lstm, f"bias_ih_l{layer}"),
                 getattr(lstm, f"bias_hh_l{layer}")))
