"""The device mesh of the port's multi-device training, the counterpart of
radtts_tpu/parallel/mesh.py: ranks laid out as (n_data, n_model), rank
r = d * n_model + m (the JAX package's devices.reshape(n_data, n_model)),
a process group along each axis, and the tensor-parallel rule.

  * 'data': each data rank loads its own rows of the global batch; the
    loss normalizers and the gradients are summed over the data group;
  * 'model': tensor parallelism over the WN coupling networks' hidden
    channels. `tp_axis` is the port's copy of the JAX package's _tp_spec
    on the port's parameter names: start, in_layers[i] and res_skip[i] of
    every decoder flow's WN keep a slice of their output channels (weight_v,
    weight_g and bias alike), end a slice of its input channels; a tensor
    whose width n_model does not divide stays whole, and so does every
    other parameter.

Launch contract (the reference's torch.distributed.launch --use_env, and
torchrun's): RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, and LOCAL_RANK
(default RANK) and LOCAL_WORLD_SIZE (default WORLD_SIZE: every rank on one
host) for the card of each rank. Backend rule: NCCL when the device is a
card and every local rank has a card of its own (LOCAL_WORLD_SIZE at most
torch.cuda.device_count()); gloo on the CPU and when ranks share a card,
which NCCL refuses. With gloo and a loopback MASTER_ADDR, GLOO_SOCKET_IFNAME
defaults to lo, as train.py sets it. A failure to initialize raises; there
is no quiet single-process run.

The XLA-only MultiHostStepRunner (radtts_tpu/train/trainer.py:193-242)
has no counterpart: PyTorch compiles nothing ahead of a step, so no rank
can reach a collective's rendezvous minutes after another.
"""

import dataclasses
import os
import re
from datetime import timedelta

import torch
import torch.distributed as dist

_WN_LEAF = re.compile(r"^flows\.\d+\.affine\.pred\."
                      r"(start|in_layers\.\d+|res_skip\.\d+|end)\."
                      r"(weight_v|weight_g|weight|bias)$")
LOOPBACK = ("127.0.0.1", "localhost", "::1")


def tp_axis(name, shape, n_model):
    """The axis of the port's parameter `name` (of this shape) that
    tensor parallelism over n_model ranks shards, or None (whole): the
    output channels (axis 0) of a decoder WN's start, in_layers and
    res_skip tensors, the input channels (axis 1) of its end weight
    (radtts_tpu/parallel/mesh.py:41-65)."""
    if n_model <= 1:
        return None
    m = _WN_LEAF.match(name)
    if m is None:
        return None
    layer, leaf = m.groups()
    if layer == "end":
        axis = 1 if leaf == "weight" and len(shape) == 3 else None
    else:
        axis = 0
    if axis is None or shape[axis] % n_model:
        return None
    return axis


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """What a tensor-parallel module needs: its model group, this rank's
    place in it and the group's size."""
    group: object
    rank: int
    size: int


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the (n_data, n_model) layout and the
    groups of its data and model axes."""
    rank: int
    n_data: int
    n_model: int
    data_group: object
    model_group: object
    backend: str

    @property
    def data_rank(self):
        return self.rank // self.n_model

    @property
    def model_rank(self):
        return self.rank % self.n_model

    @property
    def is_rank0(self):
        return self.rank == 0

    @property
    def model_shard(self):
        return ModelShard(self.model_group, self.model_rank, self.n_model)


def make_mesh(n_model=1):
    """The (world / n_model, n_model) mesh of the initialized process
    group. Every rank creates every group, in one order, as
    torch.distributed.new_group asks."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_model < 1 or world % n_model:
        raise ValueError(f"n_model {n_model} does not divide {world} "
                         "devices")
    n_data = world // n_model
    data_group = model_group = None
    for d in range(n_data):
        group = dist.new_group([d * n_model + m for m in range(n_model)])
        if rank // n_model == d:
            model_group = group
    for m in range(n_model):
        group = dist.new_group([d * n_model + m for d in range(n_data)])
        if rank % n_model == m:
            data_group = group
    return Mesh(rank, n_data, n_model, data_group, model_group,
                dist.get_backend())


def launch_env():
    """(rank, world size, local rank, local world size) of the launch
    environment; (0, 1, 0, 1) where it names none."""
    env = os.environ
    rank = int(env.get("RANK", "0"))
    world = int(env.get("WORLD_SIZE", "1"))
    local_rank = int(env.get("LOCAL_RANK", str(rank)))
    local_world = int(env.get("LOCAL_WORLD_SIZE", str(world)))
    return rank, world, local_rank, local_world


def local_device(local_rank):
    """The card of a local rank: cuda:(local_rank % device_count)."""
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def backend_for(device, local_world):
    """NCCL when every local rank has a card of its own, else gloo."""
    if device.type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_distributed(device, n_model=1):
    """init_process_group from the launch environment (see the module's
    docstring) for ranks on `device`, then make_mesh(n_model). Prints the
    backend; raises when MASTER_ADDR or MASTER_PORT is missing or the
    group cannot form."""
    rank, world, _, local_world = launch_env()
    for key in ("MASTER_ADDR", "MASTER_PORT"):
        if key not in os.environ:
            raise RuntimeError(f"WORLD_SIZE={world} needs {key} in the "
                               "environment")
    device = torch.device(device)
    backend = backend_for(device, local_world)
    if backend == "gloo" and os.environ["MASTER_ADDR"] in LOOPBACK:
        # every rank on this host: keep gloo's sockets on the loopback
        # (its default is the first external interface)
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    kwargs = {}
    if backend == "nccl":
        torch.cuda.set_device(device)
        kwargs["device_id"] = device
    dist.init_process_group(backend, init_method="env://", world_size=world,
                            rank=rank, timeout=timedelta(minutes=10),
                            **kwargs)
    mesh = make_mesh(n_model)
    print(f"> distributed: rank {rank} of {world}, backend {backend}, mesh "
          f"data={mesh.n_data} x model={mesh.n_model}, device {device}",
          flush=True)
    return mesh
