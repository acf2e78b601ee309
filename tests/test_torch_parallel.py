"""The port's training on more than one device, on the CPU: gloo worlds on
the loopback, each rank a process of tests/torch_dist_child.py launched
with the env contract (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), held
against the single-process port and the JAX package's single-device
make_train_step on the global batch (tests/test_torch_train_step.py's
config, batch and step, dropout off), and the port's tensor-parallel rule
against the JAX package's _tp_spec.

The batch's three rows are split [2, 1] over the data ranks, whose frame
and token counts differ: the global batch's loss (the normalizers summed
over the ranks) then differs from the mean of the ranks' own losses, as
asserted here."""

import functools
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from radtts_tpu.models.coupling import wn_apply, wn_init
from radtts_tpu.parallel.mesh import _path_str, _tp_spec
from radtts_tpu.train.checkpoint import save_checkpoint
from radtts_tpu.train.optim import build_optimizer as jax_build_optimizer
from radtts_tpu.train.trainer import build_trainable_mask as jax_mask
from radtts_tpu.train.trainer import make_train_step
from tests.small_model import MODEL_CONFIG
from tests.test_torch_resume import close_params
from tests.test_torch_synthesizer_parity import np_tree
from tests.test_torch_train_forward import LOSS_WEIGHTS, make_batch, to_torch
from tests.test_torch_train_forward import jax_params as _jax_params

from radtts_tpu_torch import convert
from radtts_tpu_torch.convert import element_map, radtts_train_from_jax
from radtts_tpu_torch.export import export_torch_checkpoint
from radtts_tpu_torch.models.coupling import WN
from radtts_tpu_torch.models.radtts import RADTTS, fold_radtts
from radtts_tpu_torch.parallel import mesh as port_mesh
from radtts_tpu_torch.train.checkpoint import load_train_checkpoint
from radtts_tpu_torch.train.optim import build_optimizer
from radtts_tpu_torch.train.trainer import (apply_trainable_mask,
                                            build_trainable_mask,
                                            compute_loss, train_step)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "torch_dist_child.py")
LR = 1e-3
SPLIT = [2, 1]                 # rows of each data rank
STEPS = [(True, True)]         # binarized, with the KL loss: MAS runs
RESUME_STEPS = [(False, False)]
WN_ARGS = (5, 7, 3, 8)         # n_in, n_context, n_layers, n_channels


@pytest.fixture(autouse=True)
def one_thread():
    """This file's small models run on one intra-op thread: where the
    suite's workers share the cores, OpenMP's barriers stall its many
    short ops (a 4 s test took 169 s at 8 threads a worker)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def jax_params(seed):
    """test_torch_train_forward's tree (its spectral norms converged: not
    cheap), made once a seed; its leaves are immutable JAX arrays."""
    return _jax_params(seed=seed)


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(mode, workdir, world):
    """`world` ranks of the child in `mode`, started."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
               WORLD_SIZE=str(world), GLOO_SOCKET_IFNAME="lo",
               OMP_NUM_THREADS="1")
    return mode, workdir, [subprocess.Popen(
        [sys.executable, CHILD, mode, str(workdir)], cwd=REPO,
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def finish(started, timeout=240):
    """The started ranks' results and outputs, by rank; every rank must
    exit 0 within timeout seconds (all are killed after)."""
    mode, workdir, procs = started
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-3000:]}"
    return [torch.load(os.path.join(workdir, f"{mode}_{r}.pt"),
                       weights_only=False) for r in range(len(procs))], logs


def spawn(mode, workdir, world, timeout=240):
    return finish(start(mode, workdir, world), timeout)


def jax_wn():
    """A WN of WN_ARGS from wn_init, its zero-init end drawn, and its
    inputs, as numpy."""
    n_in, n_ctx, n_layers, n_ch = WN_ARGS
    params = wn_init(jax.random.PRNGKey(3), n_in, n_ctx, n_layers, n_ch)
    rng = np.random.default_rng(3)
    params["end"]["w"] = jnp.asarray(
        rng.normal(0, 0.1, params["end"]["w"].shape).astype(np.float32))
    B, T = 2, 11
    lens = np.array([11, 7])
    inputs = {"z": rng.normal(size=(B, T, n_in)).astype(np.float32),
              "context": rng.normal(size=(B, T, n_ctx)).astype(np.float32),
              "mask": np.arange(T)[None, :] < lens[:, None],
              "grad_out": rng.normal(size=(B, T, 2 * n_in)).astype(
                  np.float32)}
    return params, inputs


def port_wn(params):
    wn = WN(*WN_ARGS, factored=True)
    convert._wn(wn, np_tree(params))
    return wn


def single_step(batch, steps, resume=None, params=None):
    """The single-process port's steps on the global batch: (model,
    optimizer, records)."""
    model = radtts_train_from_jax(np_tree(params or jax_params(seed=1)),
                                  MODEL_CONFIG)
    trainable = apply_trainable_mask(model, build_trainable_mask(model))
    opt = build_optimizer(trainable, "RAdam", LR, 1e-2)
    if resume:
        load_train_checkpoint(resume, model, opt, MODEL_CONFIG)
    records = []
    for binarize, use_kl in steps:
        total, _, gnorm = train_step(model, opt, trainable, batch,
                                     MODEL_CONFIG, LOSS_WEIGHTS, 1.0,
                                     binarize, use_kl, 1.0)
        records.append((float(total), float(gnorm)))
    return model, opt, records


def jax_step(steps):
    """make_train_step (test_torch_train_step.py's) on the global batch:
    (params, [(total, grad norm)]), and a step function for more."""
    params = jax_params(seed=1)
    optimizer = jax_build_optimizer("RAdam", LR, 1e-2, 1.0)
    step = make_train_step(MODEL_CONFIG, LOSS_WEIGHTS, 1.0, optimizer,
                           jax_mask(params, "all", ()))
    opt_state = optimizer.init(params)
    jb = {k: jnp.asarray(v) for k, v in make_batch(seed=4).items()}
    records = []
    for binarize, use_kl in steps:
        params, opt_state, total, _, gnorm = step(params, opt_state, jb,
                                                  None, binarize, use_kl)
        records.append((float(total), float(gnorm)))
    return params, opt_state, records


def jax_checkpoint(path):
    """The JAX package's model_1.npz of jax_params(seed=2) with a RAdam
    state at count 2 whose moments are drawn (no step compiled)."""
    params = jax_params(seed=2)
    optimizer = jax_build_optimizer("RAdam", LR, 1e-2, 1.0)
    clip, moments = optimizer.init(params)
    rng = np.random.default_rng(7)

    def draw(scale, positive):
        def fn(leaf):
            a = rng.standard_normal(np.shape(leaf)).astype(np.float32)
            return jnp.asarray(np.abs(a) * scale if positive else a * scale)
        return fn
    moments = moments._replace(
        count=jnp.asarray(2, moments.count.dtype),
        mu=jax.tree.map(draw(1e-3, False), moments.mu),
        nu=jax.tree.map(draw(1e-6, True), moments.nu))
    save_checkpoint(path, params, (clip, moments), 1, LR)
    return path + ".npz"


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The worlds of 2 and of 4 ranks (torch_dist_child.py's world2 and
    world4), run at once, and what they were given."""
    work = tmp_path_factory.mktemp("world2")
    wn_params, wn_inputs = jax_wn()
    inputs = {
        "model_config": MODEL_CONFIG, "loss_weights": LOSS_WEIGHTS,
        "lr": LR, "split": SPLIT, "steps": STEPS,
        "resume_steps": RESUME_STEPS,
        "resume_npz": jax_checkpoint(str(work / "model_1")),
        "model_state": radtts_train_from_jax(np_tree(jax_params(seed=1)),
                                             MODEL_CONFIG).state_dict(),
        "batch": to_torch(make_batch(seed=4)),
        "wn": {"args": WN_ARGS, "state": port_wn(wn_params).state_dict(),
               **{k: torch.from_numpy(v) for k, v in wn_inputs.items()}}}
    torch.save(inputs, work / "inputs.pt")
    work4 = tmp_path_factory.mktemp("world4")
    torch.save(inputs, work4 / "inputs.pt")
    started = [start("world2", work, 2), start("world4", work4, 4)]
    (r2, l2), (r4, l4) = (finish(s) for s in started)
    return ((work, r2, l2, (wn_params, wn_inputs)), (work4, r4, l4))


@pytest.fixture(scope="module")
def world2(worlds):
    return worlds[0]


@pytest.fixture(scope="module")
def world4(worlds):
    return worlds[1]


@pytest.fixture(scope="module")
def references():
    """The single-process port and JAX, each one step on the global
    batch."""
    model, _, port_records = single_step(to_torch(make_batch(seed=4)),
                                         STEPS)
    params, _, jax_records = jax_step(STEPS)
    return model, params, port_records, jax_records


def test_backend_rule_and_launch_env(monkeypatch):
    """gloo on the CPU and where ranks share a card; NCCL where every
    local rank has one; the env contract's defaults."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    assert port_mesh.backend_for(cpu, 1) == "gloo"
    assert port_mesh.backend_for(card, 2) == "nccl"
    assert port_mesh.backend_for(card, 4) == "gloo"
    assert port_mesh.local_device(3) == torch.device("cuda", 1)
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    assert port_mesh.launch_env() == (0, 1, 0, 1)
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert port_mesh.launch_env() == (3, 4, 3, 4)


def test_port_shards_the_leaves_jax_shards():
    """Enumerated from the JAX package's _tp_spec at n_model 2 (and 4):
    the port's parameters that tp_axis shards are exactly those drawn from
    the JAX leaves _tp_spec shards, and each rank's slice of the port's
    parameter holds the elements of rank's slice of the JAX leaf."""
    tree = np_tree(jax_params(seed=1))
    emap = element_map(lambda t: radtts_train_from_jax(t, MODEL_CONFIG),
                       tree)
    leaves = dict(convert.tree_leaves(tree))
    shapes = {n: tuple(p.shape) for n, p in RADTTS(
        MODEL_CONFIG, factored=True).named_parameters()}
    for n_model in (2, 4):
        jax_specs = {}

        def visit(path, leaf):
            spec = _tp_spec(_path_str(path), leaf, n_model)
            if spec is not None:
                jax_specs[_path_str(path)] = spec
            return leaf
        jax.tree_util.tree_map_with_path(visit, tree)
        assert jax_specs
        from_jax = {name for name, hit in emap.items() if hit is not None
                    and all(path in jax_specs for path, _, _ in hit)}
        touched = {name for name, hit in emap.items() if hit is not None
                   and any(path in jax_specs for path, _, _ in hit)}
        port = {name for name, shape in shapes.items()
                if port_mesh.tp_axis(name, shape, n_model) is not None}
        assert port == from_jax == touched
        for name in port:
            ((path, pos, idx),) = emap[name]
            axis = port_mesh.tp_axis(name, shapes[name], n_model)
            jax_axis = [i for i, a in enumerate(jax_specs[path])
                        if a == "model"][0]
            leaf_shape = leaves[path].shape
            flat = np.empty(int(np.prod(shapes[name])), np.int64)
            flat[pos] = idx
            flat = flat.reshape(shapes[name])
            ids = np.arange(int(np.prod(leaf_shape))).reshape(leaf_shape)
            for r in range(n_model):
                got = np.sort(convert.tp_slice(torch.from_numpy(flat), axis,
                                               r, n_model).numpy().ravel())
                w = leaf_shape[jax_axis] // n_model
                want = np.sort(np.take(ids, np.arange(r * w, (r + 1) * w),
                                       axis=jax_axis).ravel())
                np.testing.assert_array_equal(got, want, err_msg=name)


def test_collectives_forward_and_backward(world2):
    """gather: each rank's slice in its place, backward the rank's slice
    of the summed gradient; copy_to_group: identity, backward summed;
    reduce: summed, backward identity."""
    _, results, _, _ = world2
    c = [r["collectives"] for r in results]
    assert all(r["backend"] == "gloo" for r in results)
    full = torch.cat([c[0]["x"], c[1]["x"]], dim=-1)
    summed = c[0]["gather_grad_in"] + c[1]["gather_grad_in"]
    for r in range(2):
        assert torch.equal(c[r]["gather"], full)
        assert torch.equal(c[r]["gather_grad"],
                           summed[..., 4 * r:4 * (r + 1)])
        assert torch.equal(c[r]["copy_y"], c[r]["copy_x"])
        torch.testing.assert_close(
            c[r]["copy_grad"], c[0]["copy_grad_in"] + c[1]["copy_grad_in"],
            rtol=0, atol=0)
        torch.testing.assert_close(c[r]["reduce_y"],
                                   c[0]["reduce_x"] + c[1]["reduce_x"],
                                   rtol=0, atol=0)
        assert torch.equal(c[r]["reduce_grad"], c[r]["reduce_grad_in"])


def test_sharded_wn_matches_whole_and_jax(world2):
    """The WN at n_model=2 against the whole WN and JAX's wn_apply: the
    output, the gradients of z and the context, and every parameter's
    gradient (the ranks' shards joined along the sharded axis) within
    1e-5 of each one's max."""
    _, results, _, (params, inputs) = world2
    wn = port_wn(params)
    z = torch.from_numpy(inputs["z"]).requires_grad_(True)
    ctx = torch.from_numpy(inputs["context"]).requires_grad_(True)
    y = wn(z, ctx, mask=torch.from_numpy(inputs["mask"]))
    y.backward(torch.from_numpy(inputs["grad_out"]))

    def jax_fn(p, z, c):
        out = wn_apply(p, z, c, mask=jnp.asarray(inputs["mask"]))
        return jnp.sum(out * inputs["grad_out"]), out
    (_, j_out), j_grads = jax.value_and_grad(jax_fn, (0, 1, 2),
                                             has_aux=True)(
        params, jnp.asarray(inputs["z"]), jnp.asarray(inputs["context"]))

    def close(got, want, what):
        want = np.asarray(want)
        err = np.abs(np.asarray(got) - want).max()
        assert err <= 1e-5 * np.abs(want).max(), (what, err)

    shards = [r["wn"] for r in results]
    assert all(s["tp"] for s in shards)
    prefix = "flows.0.affine.pred."
    assert set(shards[0]["axes"]) == {
        prefix + n for n, p in wn.named_parameters()
        if not n.startswith("end.bias")}
    for s in shards:
        close(s["out"], y.detach(), "out")
        close(s["out"], j_out, "out vs jax")
        close(s["z_grad"], z.grad, "z")
        close(s["z_grad"], j_grads[1], "z vs jax")
        close(s["context_grad"], ctx.grad, "context")
        close(s["context_grad"], j_grads[2], "context vs jax")
    j_port = WN(*WN_ARGS, factored=True)
    convert._wn(j_port, np_tree(j_grads[0]))
    j_named = dict(j_port.named_parameters())
    for name, p in wn.named_parameters():
        key = prefix + name
        axis = shards[0]["axes"].get(key)
        got = (shards[0]["param_grads"][key] if axis is None else
               torch.cat([s["param_grads"][key] for s in shards], axis))
        if axis is None:
            assert torch.equal(got, shards[1]["param_grads"][key])
        close(got, p.grad, name)
        close(got, j_named[name].detach(), name + " vs jax")


@pytest.mark.parametrize("layout", ["2x1", "1x2", "2x2"])
def test_step_matches_single_process_and_jax(request, world2, references,
                                             layout):
    """One binarized step with the KL loss, data-parallel over 2 ranks of
    2 and 1 rows, tensor-parallel over 2, and both on 4 ranks: the loss
    within rtol 2e-4 and the grad norm within 2e-3 of the single-process
    port's and JAX's on the global batch; the updated parameters (gathered
    by rank 0 into a checkpoint) by test_torch_train_step.py's rule
    against both; every rank reports the global numbers."""
    work, results = ((world2[0], world2[1]) if layout != "2x2" else
                     request.getfixturevalue("world4")[:2])
    model, params, port_records, jax_records = references
    tag = f"step_{layout}"
    n_model = int(layout[-1])
    for r in results:
        rec = r[tag]["steps"][0]
        for want_total, want_gn in (port_records[0], jax_records[0]):
            np.testing.assert_allclose(rec["total"], want_total, rtol=2e-4)
            np.testing.assert_allclose(rec["grad_norm"], want_gn, rtol=2e-3)
        assert bool(r[tag]["axes"]) == (n_model > 1)
    ckpt = torch.load(work / f"{tag}_state", weights_only=True)
    got = RADTTS(MODEL_CONFIG, factored=True)
    got.load_state_dict(ckpt["model"])
    close_params(got, model, LR)
    close_params(got, radtts_train_from_jax(np_tree(params), MODEL_CONFIG),
                 LR)


def test_global_loss_is_not_the_mean_of_rank_losses(references):
    """The split's two halves hold different frame and token counts: the
    mean of their own losses is not the global batch's loss, which the
    parallel steps reproduce (above)."""
    model = radtts_train_from_jax(np_tree(jax_params(seed=1)), MODEL_CONFIG)
    batch = to_torch(make_batch(seed=4))
    own = []
    with torch.no_grad():
        total, _, _ = compute_loss(model, batch, MODEL_CONFIG, LOSS_WEIGHTS,
                                   1.0, *STEPS[0])
        for lo, hi in ((0, SPLIT[0]), (SPLIT[0], sum(SPLIT))):
            part = {k: v[lo:hi] for k, v in batch.items()}
            own.append(float(compute_loss(model, part, MODEL_CONFIG,
                                          LOSS_WEIGHTS, 1.0, *STEPS[0])[0]))
    assert abs(np.mean(own) - float(total)) > 1e-2 * abs(float(total))


def test_tp_checkpoint_loads_in_one_process_and_jax(world2, references,
                                                     tmp_path):
    """The tensor-parallel step's checkpoint (rank 0's, gathered) has the
    single-process layout: it loads into a single-process model and
    resumes there, and through the port's exporter into the JAX package,
    whose tree holds the same weights."""
    from radtts_tpu.train.checkpoint import load_any_radtts_checkpoint

    work = world2[0]
    model = RADTTS(MODEL_CONFIG, factored=True)
    trainable = apply_trainable_mask(model, build_trainable_mask(model))
    opt = build_optimizer(trainable, "RAdam", LR, 1e-2)
    load_train_checkpoint(str(work / "step_1x2_state"), model, opt,
                          MODEL_CONFIG)
    assert all(opt.state[p]["exp_avg"].shape == p.shape for p in trainable)
    close_params(model, references[0], LR)
    export_torch_checkpoint(str(tmp_path / "ref.pt"), model)
    tree, _ = load_any_radtts_checkpoint(str(tmp_path / "ref.pt"),
                                         MODEL_CONFIG, jax_params(seed=1))
    folded = fold_radtts(model)
    for i, flow in enumerate(folded.flows):
        got = np.asarray(tree["flows"][i]["affine"]["pred"]["end"]["w"])
        np.testing.assert_array_equal(
            got, flow.affine.pred.end.weight.detach().numpy()
            .transpose(2, 1, 0))


def test_resume_npz_into_tensor_parallel(world2):
    """--resume of the JAX package's unsharded .npz (weights and a RAdam
    state at count 2) into an n_model=2 run continues as one process
    does: the next step's loss and grad norm, and the parameters after
    it."""
    work, results, _, _ = world2
    model, _, records = single_step(to_torch(make_batch(seed=4)),
                                    RESUME_STEPS,
                                    resume=str(work / "model_1.npz"))
    for r in results:
        rec = r["resume_1x2"]["steps"][0]
        np.testing.assert_allclose(rec["total"], records[0][0], rtol=2e-4)
        np.testing.assert_allclose(rec["grad_norm"], records[0][1],
                                   rtol=2e-3)
    ckpt = torch.load(work / "resume_1x2_state", weights_only=True)
    got = RADTTS(MODEL_CONFIG, factored=True)
    got.load_state_dict(ckpt["model"])
    close_params(got, model, LR)
