"""LinearNorm (channels-last nn.Linear with xavier-uniform init and a
gain) and DenseLayer (a tanh MLP, radtts_tpu/ops/linear.py:28-41)."""

import math

import torch
import torch.nn.functional as F
from torch import nn

GAINS = {"linear": 1.0, "relu": math.sqrt(2.0), "tanh": 5.0 / 3.0,
         "sigmoid": 1.0}


class LinearNorm(nn.Linear):
    """nn.Linear (weight (out, in)) with the reference's xavier init. In an
    AMP region (x bf16) the weight and bias follow x, the bias added after
    the product, as the JAX package's linear_apply does."""

    def __init__(self, in_dim, out_dim, bias=True, gain_name="linear"):
        super().__init__(in_dim, out_dim, bias=bias)
        nn.init.xavier_uniform_(self.weight, gain=GAINS[gain_name])

    def forward(self, x):
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        y = F.linear(x, self.weight.to(x.dtype))
        return y if self.bias is None else y + self.bias.to(x.dtype)



class DenseLayer(nn.Module):
    """tanh(Linear) for each of `sizes` in turn."""

    def __init__(self, in_dim, sizes):
        super().__init__()
        dims = [in_dim] + list(sizes)
        self.layers = nn.ModuleList(LinearNorm(a, b)
                                    for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for layer in self.layers:
            x = torch.tanh(layer(x))
        return x
