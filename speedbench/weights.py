"""Seeded weights, made on the device in a few large calls.

One normal draw fills every drawn tensor (each a view of one buffer,
scaled to its sd); the LU-factored 1x1 convolutions take a random rotation
each (one batched QR and LU per width). The configuration's
`assumed.init` overrides the init of every tensor whose name ends with
one of its keys: the small sd of the layers that the model
zero-initialises, whose zeros would make decode vacuous.
"""

import torch


def make_weights(specs, seed, device, overrides=None):
    """{name: tensor} for the [(name, shape, init)] of `specs`, drawn from
    `seed` on `device` (float32)."""
    overrides = overrides or {}

    def init(name, default):
        for suffix, value in overrides.items():
            if name.endswith(suffix):
                return tuple(value)
        return tuple(default)

    specs = [(n, tuple(s), init(n, i)) for n, s, i in specs]
    gen = torch.Generator(device).manual_seed(int(seed) % 2 ** 63)
    drawn = [(n, s, i) for n, s, i in specs
             if i[0] in ("normal", "spectral")]
    total = sum(_aligned(_numel(s)) for _, s, _ in drawn)
    flat = torch.randn(total, generator=gen, device=device)
    out, offset = {}, 0
    for name, shape, init in drawn:
        n = _numel(shape)
        out[name] = flat[offset:offset + n].view(shape).mul_(init[1])
        offset += _aligned(n)
    for name, shape, init in specs:
        if init[0] == "ones":
            out[name] = torch.ones(shape, device=device)
        elif init[0] == "zeros":
            out[name] = torch.zeros(shape, device=device)
    spectral = [n for n, _, i in specs if i[0] == "spectral"]
    for name in spectral:
        # a converged spectral norm: the largest singular value is 1
        out[name].div_(torch.linalg.matrix_norm(out[name], ord=2))
    widths = {n.rsplit(".", 1)[0]: s[0] for n, s, i in specs
              if i[0] == "orthonormal" and n.endswith(".p")}
    _rotations(out, widths, gen, device)
    return out


def _aligned(n, floats=64):
    """n rounded up so that every view starts 256-byte aligned (the
    program's kernels take 16-byte-aligned weights)."""
    return -(-n // floats) * floats


def _numel(shape):
    n = 1
    for d in shape:
        n *= d
    return n


def _rotations(out, widths, gen, device):
    """p, lower, upper, upper_diag of W = P L U for a random rotation W
    of each 1x1 convolution ({prefix: width})."""
    by_width = {}
    for p in sorted(widths):
        by_width.setdefault(widths[p], []).append(p)
    for c, group in sorted(by_width.items()):
        a = torch.randn(len(group), c, c, generator=gen, device=device,
                        dtype=torch.float64)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))[:, None, :]
        # det +1: flip the first column where it is -1
        det = torch.linalg.det(q)
        q[:, :, 0] *= torch.where(det < 0, -1.0, 1.0)[:, None]
        P, L, U = torch.linalg.lu(q)
        for k, prefix in enumerate(group):
            out[prefix + ".p"] = P[k].float().contiguous()
            out[prefix + ".lower"] = torch.tril(L[k], -1).float().contiguous()
            out[prefix + ".upper"] = torch.triu(U[k], 1).float().contiguous()
            out[prefix + ".upper_diag"] = torch.diagonal(U[k]).float() \
                .contiguous()

