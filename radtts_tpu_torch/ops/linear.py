"""LinearNorm (channels-last nn.Linear with xavier-uniform init and a
gain)."""

import math

from torch import nn

GAINS = {"linear": 1.0, "relu": math.sqrt(2.0), "tanh": 5.0 / 3.0,
         "sigmoid": 1.0}


class LinearNorm(nn.Linear):
    """nn.Linear (weight (out, in)) with the reference's xavier init."""

    def __init__(self, in_dim, out_dim, bias=True, gain_name="linear"):
        super().__init__(in_dim, out_dim, bias=bias)
        nn.init.xavier_uniform_(self.weight, gain=GAINS[gain_name])

