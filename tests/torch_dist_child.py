"""One rank of the multi-process tests of the port's parallel paths
(tests/test_torch_parallel*.py), launched by them with the env contract
(RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) on gloo over the loopback:

    python tests/torch_dist_child.py MODE WORKDIR

It imports no JAX: the test writes its inputs to WORKDIR/inputs.pt and
compares what each rank writes to WORKDIR/<mode>_<rank>.pt with JAX and
with the single-process port.

Modes:
  world2  (2 ranks) the three collectives forward and backward; the WN
          sharded at n_model=2; a training step at (n_data, n_model) =
          (2, 1) and (1, 2) on the inputs' batch, its rows split over
          the data ranks as inputs["split"] says; the (1, 2) step
          resumed from the inputs' JAX .npz; each step's state gathered
          and written by rank 0 (train/checkpoint.py:
          save_train_checkpoint);
  world4  (4 ranks) the step at (2, 2);
  cli     the training CLI's main (python -m radtts_tpu_torch.train's)
          with the inputs' argv and each run's extra -p settings (run i on
          MASTER_PORT + i), recording the rows each rank loaded and which
          rank wrote the output folder and checkpoints.
"""

import os
import sys

import torch
from torch import nn

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from radtts_tpu_torch.models.coupling import WN  # noqa: E402
from radtts_tpu_torch.models.radtts import RADTTS  # noqa: E402
from radtts_tpu_torch.parallel import (collectives, full_train_state,  # noqa
                                       shard_model)
from radtts_tpu_torch.parallel.mesh import (init_distributed,  # noqa: E402
                                            make_mesh)
from radtts_tpu_torch.train import trainer  # noqa: E402
from radtts_tpu_torch.train.checkpoint import (  # noqa: E402
    load_train_checkpoint, save_train_checkpoint)
from radtts_tpu_torch.train.optim import build_optimizer  # noqa: E402


def collectives_check(mesh, seed=0):
    """Each collective on this rank's inputs: their values and gradients."""
    shard = mesh.model_shard
    g = torch.Generator().manual_seed(seed + mesh.rank)
    x = torch.randn(2, 3, 4, generator=g, requires_grad=True)
    grad = torch.randn(2, 3, 4 * shard.size, generator=g)
    full = collectives.gather(x, shard)
    full.backward(grad)
    out = {"x": x.detach(), "gather": full.detach(), "gather_grad_in": grad,
           "gather_grad": x.grad}
    for name, fn in (("copy", collectives.copy_to_group),
                     ("reduce", collectives.reduce)):
        x = torch.randn(2, 5, generator=g, requires_grad=True)
        grad = torch.randn(2, 5, generator=g)
        y = fn(x, shard)
        y.backward(grad)
        out.update({f"{name}_x": x.detach(), f"{name}_y": y.detach(),
                    f"{name}_grad_in": grad, f"{name}_grad": x.grad})
    return out


def wn_check(mesh, spec):
    """The WN of spec["state"] sharded at n_model=2 (under a decoder flow's
    parameter names, as the rule reads them): its output, input gradients
    and this rank's parameter gradients."""
    wn = WN(*spec["args"], factored=True)
    wn.load_state_dict(spec["state"])
    holder = nn.Module()
    holder.flows = nn.ModuleList([nn.Module()])
    holder.flows[0].affine = nn.Module()
    holder.flows[0].affine.pred = wn
    axes = shard_model(holder, None, mesh)
    z = spec["z"].clone().requires_grad_(True)
    ctx = spec["context"].clone().requires_grad_(True)
    y = wn(z, ctx, mask=spec["mask"])
    y.backward(spec["grad_out"])
    return {"out": y.detach(), "z_grad": z.grad, "context_grad": ctx.grad,
            "axes": axes, "tp": wn.tp is not None,
            "param_grads": {n: p.grad for n, p in holder.named_parameters()}}


def build(inputs):
    model = RADTTS(inputs["model_config"], factored=True)
    model.load_state_dict(inputs["model_state"])
    trainable = trainer.apply_trainable_mask(
        model, trainer.build_trainable_mask(model, "all"))
    opt = build_optimizer(trainable, "RAdam", inputs["lr"], 1e-2)
    return model.train(), trainable, opt


def rows(batch, mesh, split):
    """This data rank's rows: split[d] of them for data rank d."""
    if mesh.n_data == 1:
        return batch
    lo = sum(split[:mesh.data_rank])
    return {k: v[lo:lo + split[mesh.data_rank]] for k, v in batch.items()}


def step_check(mesh, inputs, tag, resume=None):
    """The inputs' steps on this layout; the state gathered by every rank
    and written by rank 0 to WORKDIR/<tag>_state (a training
    checkpoint)."""
    model, trainable, opt = build(inputs)
    if resume:
        load_train_checkpoint(resume, model, opt, inputs["model_config"])
    axes = shard_model(model, opt, mesh)
    sharded = [p for n, p in model.named_parameters() if n in axes]
    batch = rows(inputs["batch"], mesh, inputs["split"])
    mc, lw = inputs["model_config"], inputs["loss_weights"]
    out = {"axes": axes, "steps": []}
    for binarize, use_kl in inputs["steps"]:
        total, loss_dict, gnorm = trainer.train_step(
            model, opt, trainable, batch, mc, lw, 1.0, binarize, use_kl,
            1.0, mesh=mesh, sharded=sharded)
        out["steps"].append({"total": float(total),
                             "grad_norm": float(gnorm),
                             **{k: float(v) for k, (v, _) in
                                loss_dict.items()}})
    model_sd, optim_sd = full_train_state(model, opt, mesh, axes)
    if mesh.is_rank0:
        save_train_checkpoint(os.path.join(inputs["workdir"],
                                           f"{tag}_state"),
                              model_sd, optim_sd, 0, inputs["lr"])
    return out


def run_cli(inputs):
    """The training CLI's main, recording this rank's rows (the loader's
    audio paths) and its writes."""
    from radtts_tpu_torch.data import dataset

    record = {"rows": [], "writes": []}
    loader_iter = dataset.DataLoader.__iter__

    def iter_rows(self):
        for batch in loader_iter(self):
            if self.shuffle:   # the training loader
                record["rows"].append(list(batch["audiopaths"]))
            yield batch

    def writes(name, fn):
        def wrapped(*args, **kwargs):
            record["writes"].append(name)
            return fn(*args, **kwargs)
        return wrapped

    dataset.DataLoader.__iter__ = iter_rows
    trainer.save_train_checkpoint = writes("checkpoint",
                                           trainer.save_train_checkpoint)
    trainer.prepare_output_folder = writes("output_folder",
                                           trainer.prepare_output_folder)
    from radtts_tpu_torch.train import main

    runs = []
    for i, extra in enumerate(inputs["cli_runs"]):
        os.environ["MASTER_PORT"] = str(int(inputs["master_port"]) + i)
        record["rows"], record["writes"] = [], []
        history = main(inputs["cli_argv"] + [
            f"train_config.output_directory={inputs['cli_out'][i]}", *extra])
        runs.append({"history": history, "rows": record["rows"],
                     "writes": record["writes"]})
    return runs


def main():
    mode, workdir = sys.argv[1], sys.argv[2]
    inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                        weights_only=False)
    inputs["workdir"] = workdir
    rank = int(os.environ["RANK"])
    if mode == "cli":
        inputs["master_port"] = os.environ["MASTER_PORT"]
        result = run_cli(inputs)
    else:
        mesh = init_distributed(torch.device("cpu"))
        result = {"backend": mesh.backend}
        if mode == "world2":
            result["collectives"] = collectives_check(make_mesh(2))
            result["wn"] = wn_check(make_mesh(2), inputs["wn"])
            for n_model in (1, 2):
                result[f"step_{2 // n_model}x{n_model}"] = step_check(
                    make_mesh(n_model), inputs, f"step_{2 // n_model}x"
                    f"{n_model}")
            result["resume_1x2"] = step_check(
                make_mesh(2), dict(inputs, steps=inputs["resume_steps"]),
                "resume_1x2", resume=inputs["resume_npz"])
        elif mode == "world4":
            result["step_2x2"] = step_check(make_mesh(2), inputs,
                                            "step_2x2")
        torch.distributed.destroy_process_group()
    torch.save(result, os.path.join(workdir, f"{mode}_{rank}.pt"))


if __name__ == "__main__":
    main()
