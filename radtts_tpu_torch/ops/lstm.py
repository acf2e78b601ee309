"""Masked (bi)LSTMs on torch.nn.LSTM with packed sequences: `MaskedLSTM`
(one layer, one or two directions, the norm factorizations) and `LSTM`
(unidirectional, stacked, plain weights, with the carry in and out).

Packed-sequence semantics are what the JAX package reproduces with masked
scans: the forward direction stops at each sequence's length, the backward
direction starts at its last valid frame, and outputs past the length are
zero. Gate order i, f, g, o and the two bias vectors match torch.

`MaskedLSTM` runs one of three routes, `lstm_route` choosing by what the
call can observe (each run counts `lstm_<route>` in tracing.py):
  "kernel"  CUDA input, no gradient wanted (grad off, or neither the input
            nor a parameter requires it), fp32 input and weights, and W_hh
            of every direction fitting the blocks' shared memory
            (`lstm_plan`): `lstm_cuda`, one cooperative launch of
            csrc/lstm.cu's persistent kernel after one input-projection
            matmul. It reads the lengths on the card: no host transfer.
  "cudnn"   any other CUDA call (training with gradients, the bf16 AMP
            region, a width that does not fit): nn.LSTM on packed
            sequences. With lengths on the card, a run makes three
            blocking transfers, each a sync (tracing.py): the lengths'
            read, packing's copy of the sort order to the card and
            unpacking's read of it back.
  "cpu"     a CPU input: the same nn.LSTM path.
`lstm_plain` is the kernel's masked step loop in torch ops, for the tests
and chip_smoke.py.

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

import collections
import ctypes
import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils.rnn import (PackedSequence, pack_padded_sequence,
                                pad_packed_sequence)

from radtts_tpu_torch import tracing
from radtts_tpu_torch.ops import flops
from radtts_tpu_torch.ops.ar_scan import _pad4, item_group
from radtts_tpu_torch.ops.cuda_build import build_library
from radtts_tpu_torch.ops.masking import sequence_mask
from radtts_tpu_torch.ops.mrf import _cached_pack

# csrc/lstm.cu
SMEM_CAP = 232448        # kMaxSmem: a block's dynamic shared memory
WEIGHT_CACHE_SIZE = 16   # kernel_weights kept (the DAP model runs 6 LSTMs)
_weights = collections.OrderedDict()
_lib = None


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


def _reversed(t, lens):
    """t (B, T, C) with each item's first lens[b] frames in reverse order
    and zeros past them: a backward direction's frames in step order, and
    back."""
    B, T, C = t.shape
    s = torch.arange(T, device=t.device)
    idx = (lens[:, None] - 1 - s).clamp(min=0)
    valid = (s < lens[:, None])[:, :, None]
    return torch.where(valid, t.gather(1, idx[:, :, None].expand(B, T, C)),
                       0.0)


def lstm_plain(x, lengths, weights, bidirectional):
    """x (B, T, C), lengths (B,) or None (every item T long), weights in
    nn.LSTM's order (w_ih, w_hh, b_ih, b_hh a direction) -> (B, T, D*H),
    [fwd ; bwd]: the masked step loop of csrc/lstm.cu in torch ops. Step s
    of item b runs while s < len_b; the forward direction reads frame s,
    the backward frame len_b - 1 - s; states stop at the length and every
    output past it is zero (packed sequences' semantics)."""
    B, T, _ = x.shape
    lens = (torch.full((B,), T, device=x.device) if lengths is None
            else lengths.to(x.device, torch.int64).clamp(0, T))
    active = torch.arange(T, device=x.device) < lens[:, None]    # (B, T)
    outs = []
    for d in range(2 if bidirectional else 1):
        w_ih, w_hh, b_ih, b_hh = weights[4 * d:4 * d + 4]
        gx = x @ w_ih.T + (b_ih + b_hh)
        if d:
            gx = _reversed(gx, lens)
        h = c = x.new_zeros(B, w_hh.shape[1])
        ys = []
        for s in range(T):
            i, f, g, o = (gx[:, s] + h @ w_hh.T).chunk(4, dim=-1)
            c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            m = active[:, s, None]
            h, c = torch.where(m, h_new, h), torch.where(m, c_new, c)
            ys.append(torch.where(m, h_new, 0.0))
        y = torch.stack(ys, dim=1)
        outs.append(_reversed(y, lens) if d else y)
    return torch.cat(outs, dim=-1)


def lstm_plan(H, B, D, sms, smem_cap=SMEM_CAP):
    """csrc/lstm.cu's layout of D directions of H units at B items on a card
    of `sms` SMs, or None where it does not fit. Each block owns `units` U,
    the fewest with D x ceil(H / U) blocks on the card (so that every SM
    takes a block): 2, 4 and 8 at H = 128, 256 and 520 with two directions
    on 132 SMs. `kp`: H padded to 4 floats, the stride of h and of a
    weight row. `items`: the items a warp takes at once (the kernel's
    template G, as ar_scan's item_group: 1, 2, 4 or 8). `smem`: a block's
    bytes
    (csrc/lstm.cu layout()): its 4U weight rows, h of every item (B
    rounded up to whole groups of `items`), two steps of its projection,
    its cells' c and h and the lengths; the plan fits where they fit
    `smem_cap`."""
    U = -(-H * D // sms)
    while D * -(-H // U) > sms:
        U += 1
    kp = _pad4(H)
    G = item_group(B)
    smem = 4 * (4 * U * kp + -(-B // G) * G * kp + 8 * B * U + 2 * B * U
                + B)
    if smem > smem_cap:
        return None
    bpd = -(-H // U)
    return {"units": U, "blocks_per_dir": bpd, "blocks": D * bpd,
            "kp": kp, "smem": smem, "items": G}


def lstm_route(device, dtype, grad, H, B, D, sms):
    """The route of a masked LSTM run (the module's docstring): "cpu" off
    the card; "kernel" for an fp32 call (input and weights: `dtype`, None
    where they differ) that wants no gradient and whose lstm_plan fits;
    else "cudnn"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    if grad or dtype != torch.float32 or lstm_plan(H, B, D, sms) is None:
        return "cudnn"
    return "kernel"


def resident_image(w_hh, plan):
    """w_hh (D, 4H, H), each direction's recurrent weight in nn.LSTM's
    gate-major rows -> (D x blocks_per_dir, 4U x kp): block j of direction
    d holds units [j U, j U + U), row 4u + q its unit u's gate q, each row
    zero-padded to kp and the units past H zero rows."""
    D, G4, H = w_hh.shape
    U, bpd, kp = plan["units"], plan["blocks_per_dir"], plan["kp"]
    w = F.pad(w_hh.reshape(D, 4, H, H), (0, kp - H, 0, bpd * U - H))
    return w.reshape(D, 4, bpd, U, kp).permute(0, 2, 3, 1, 4).reshape(
        D * bpd, 4 * U * kp)


def kernel_weights(weights, D, plan):
    """nn.LSTM-ordered weights in the forms csrc/lstm.cu's launch takes:
    (W_ih of every direction, (D x 4H, C), b_ih + b_hh, (D x 4H), for the
    input projection, one matmul over every frame and direction; the
    blocks' resident_image), kept per weight version (ops/mrf.py:
    _cached_pack), so that serving makes them once."""
    def make():
        return (torch.cat([weights[4 * d] for d in range(D)]),
                torch.cat([weights[4 * d + 2] + weights[4 * d + 3]
                           for d in range(D)]),
                resident_image(torch.stack([weights[4 * d + 1]
                                            for d in range(D)]),
                               plan).contiguous())
    return _cached_pack(list(weights), ("lstm", plan["units"]), make,
                        _weights, WEIGHT_CACHE_SIZE)


def build():
    """Compile csrc/lstm.cu (ops/cuda_build.py) and load it. Returns
    (library, nvcc output, build seconds)."""
    global _lib
    lib, log, seconds = build_library("lstm")
    lib.radtts_lstm.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    lib.radtts_lstm.restype = ctypes.c_int
    lib.radtts_lstm_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.radtts_lstm_smem_bytes.restype = ctypes.c_int
    _lib = lib
    return lib, log, seconds


def _flop_records(x, lengths, weights, bidirectional):
    """lstm_cuda's products for ops/flops.py, as lstm_plain makes them:
    every item at every step, each direction."""
    return flops._lstm(x, weights[1].shape[1], 1, bidirectional, True, None,
                       sum(w.numel() for w in weights))


@flops.counted(_flop_records)
def lstm_cuda(x, lengths, weights, bidirectional):
    """lstm_plain's function on the card: the input projection, then one
    cooperative launch of csrc/lstm.cu's persistent kernel, which reads
    `lengths` (B,) on the device (None: every item T long) and makes no
    host transfer. fp32 only and no backward; raises where lstm_plan does
    not fit."""
    B, T, _ = x.shape
    D = 2 if bidirectional else 1
    H = weights[1].shape[1]
    dev = x.device
    if x.dtype != torch.float32 or any(w.dtype != torch.float32
                                       for w in weights):
        raise ValueError("lstm_cuda: input and weights must be float32")
    if B == 0 or T == 0:
        return x.new_zeros(B, T, D * H)
    plan = lstm_plan(H, B, D,
                     torch.cuda.get_device_properties(dev)
                     .multi_processor_count)
    if plan is None:
        raise ValueError(f"lstm_cuda: H={H} at B={B} does not fit the "
                         "blocks' shared memory")
    if _lib is None:
        build()
    w_ih, bias, img = kernel_weights(weights, D, plan)
    xproj = F.linear(x, w_ih, bias).contiguous()
    y = torch.empty(B, T, D * H, device=dev)
    kp = plan["kp"]
    # h by step parity, then one counter a direction: zero
    scratch = torch.zeros(D * 2 * B * kp + D, device=dev)
    lens = (None if lengths is None
            else lengths.to(dev, torch.int64).contiguous())
    with torch.cuda.device(dev):
        err = _lib.radtts_lstm(
            img.data_ptr(), xproj.data_ptr(),
            None if lens is None else lens.data_ptr(), y.data_ptr(),
            scratch.data_ptr(), scratch[-D:].data_ptr(), B, T, H, D,
            plan["units"], kp, plan["items"],
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lstm_cuda: launch failed with cudaError {err} "
                           f"(B={B}, T={T}, H={H}, D={D}, plan={plan})")
    lstm_cuda.launches += 1
    return y


lstm_cuda.launches = 0


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

    def weights(self):
        """The weights in nn.LSTM's order (w_ih, w_hh, b_ih, b_hh a
        direction), the training form's effective ones."""
        return (self.flat_weights() if self.factored
                else self.lstm._flat_weights)

    def route(self, x):
        """lstm_route of a run over x (B, T, C)."""
        if x.device.type != "cuda":
            return "cpu"
        params = list(self.parameters())
        grad = torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in params))
        dtype = x.dtype if all(p.dtype == x.dtype for p in params) else None
        return lstm_route(x.device, dtype, grad, self.lstm.hidden_size,
                          x.shape[0], 2 if self.lstm.bidirectional else 1,
                          torch.cuda.get_device_properties(x.device)
                          .multi_processor_count)

    def _run(self, x, T, route, lengths=None):
        """The recurrent run, in an `lstm` span that counts its padded
        steps and its route: on the "kernel" route lstm_cuda(x, lengths);
        else self.lstm(x)[0] of a tensor or a PackedSequence padded to T
        steps, whose weights, biases and states follow x's dtype (bf16 in
        an AMP region)."""
        packed = isinstance(x, PackedSequence)
        data = x.data if packed else x
        n_dir = 2 if self.lstm.bidirectional else 1
        with tracing.span("lstm", data.device):
            tracing.count("lstm_steps", T * n_dir)
            tracing.count("lstm_" + route)
            if route == "kernel":
                return lstm_cuda(x, lengths, self.weights(),
                                 self.lstm.bidirectional)
            if (not self.factored
                    and data.dtype == self.lstm.weight_ih_l0.dtype):
                return self.lstm(x)[0]
            n_batch = int(x.batch_sizes[0]) if packed else x.shape[0]
            h0 = data.new_zeros(n_dir, n_batch, self.lstm.hidden_size)
            weights = [w.to(data.dtype) for w in self.weights()]
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
        route = self.route(x)
        if route == "kernel":
            return self._run(x, x.shape[1], route, lengths)
        return self.packed(x, lengths, route)

    def packed(self, x, lengths=None, route="cudnn"):
        """The "cudnn" and "cpu" routes: nn.LSTM on packed sequences (the
        card's "before" of the kernel route in chip_smoke.py)."""
        T = x.shape[1]
        if lengths is None:
            return self._run(x, T, route)
        y = self._run(_pack(x, lengths), T, route)
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
