"""RADTTS training loop of the port (radtts_tpu/train/trainer.py:61-630):
trainable masks and freezing, the train step (power iteration, forward,
losses, backward, global-norm clip, RAdam), the curriculum, validation
with its audio samples, checkpoints, warm start and resume, a profiler
window, on one device.

The model is the training form of RADTTS (its norm factorizations held as
parameters and buffers). A frozen parameter has requires_grad False and is
not handed to the optimizer; the clip's norm is over the trainable
gradients only, as the JAX package's is over its masked gradients. A
trainable parameter the loss does not reach takes a zero gradient (its
weight decay still applies), as a masked JAX gradient is zero.

Checkpoints are torch.save of {"model": the factored state dict,
"optimizer": its state dict, "iteration", "learning_rate"} at
OUT/model_<iteration>; train/checkpoint.py reads them for resume, warm
start and serving.
"""

import hashlib
import json
import os
import tarfile
import time

import numpy as np
import torch
import torch.distributed as dist

from radtts_tpu_torch.losses import (attention_binarization_loss,
                                     loss_counts, radtts_loss)
from radtts_tpu_torch.models.radtts import RADTTS, radtts_forward
from radtts_tpu_torch.ops import amp
from radtts_tpu_torch.ops.lstm import spectral_norm_update
from radtts_tpu_torch.parallel import collectives
from radtts_tpu_torch.train.checkpoint import (load_train_checkpoint,
                                               save_train_checkpoint,
                                               warmstart_state)
from radtts_tpu_torch.train.optim import build_optimizer, clip_grad_norm

# unfreeze_modules keys -> top-level modules (reference: train.py:74-97)
MODULE_PREFIXES = {
    "dur": ("dur_pred_layer",),
    "f0": ("f0_pred_module",),
    "energy": ("energy_pred_module",),
    "vpred": ("v_pred_module", "v_embeddings"),
    "unvbias": ("unvoiced_bias",),
}

BATCH_KEYS = ("mel", "speaker_ids", "text", "input_lengths",
              "output_lengths", "attn_prior", "f0", "p_voiced",
              "voiced_mask", "energy_avg")


def build_trainable_mask(model, unfreeze_modules="all", finetune_layers=()):
    """{parameter name: trainable} (buffers, such as the spectral norms'
    vectors and the LU permutation, are not parameters)."""
    allowed = None
    if unfreeze_modules != "all":
        allowed = [p for key, prefixes in MODULE_PREFIXES.items()
                   if key in unfreeze_modules for p in prefixes]
    mask = {}
    for name, _ in model.named_parameters():
        ok = allowed is None or any(name.startswith(p) for p in allowed)
        if ok and finetune_layers:
            ok = any(layer in name for layer in finetune_layers)
        mask[name] = ok
    return mask


def apply_trainable_mask(model, mask):
    """requires_grad from the mask; returns the trainable parameters."""
    params = []
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
        if mask[name]:
            params.append(p)
    return params


def batch_to_device(batch, device):
    """A collated numpy batch as tensors on device (int64 ids and lengths,
    float32 features)."""
    out = {}
    for k in BATCH_KEYS:
        v = batch.get(k)
        if v is None:
            continue
        t = torch.from_numpy(np.asarray(v))
        out[k] = t.to(device, non_blocking=True)
    return out


def compute_loss(model, batch, model_config, loss_weights, sigma, binarize,
                 use_kl, generator=None, mesh=None):
    """(total loss, {name: (value, weight)}, model outputs), as the JAX
    make_train_step's loss_fn computes them. With a mesh, the batch is
    this data rank's rows and each value its share of the global batch's
    loss: the normalizers' counts are summed over the data group first
    (losses.loss_counts, one all-reduce), so the sum over the group's
    ranks is the loss of the global batch."""
    out = radtts_forward(
        model, batch["mel"], batch["speaker_ids"], batch["text"],
        batch["input_lengths"], batch["output_lengths"],
        binarize_attention_flag=binarize,
        attn_prior=batch.get("attn_prior"), f0=batch.get("f0"),
        energy_avg=batch.get("energy_avg"),
        voiced_mask=batch.get("voiced_mask"),
        p_voiced=batch.get("p_voiced"), generator=generator)
    with_bin = use_kl and binarize
    configs = dict(dur_model_config=model_config.get("dur_model_config"),
                   f0_model_config=model_config.get("f0_model_config"),
                   energy_model_config=model_config.get(
                       "energy_model_config"),
                   vpred_model_config=model_config.get("v_model_config"))
    counts, share = {}, 1.0
    if mesh is not None:
        names, local = loss_counts(out, batch["input_lengths"],
                                   batch["output_lengths"],
                                   binarization=with_bin, **configs)
        dist.all_reduce(local, group=mesh.data_group)
        counts = dict(zip(names, local))
        share = 1.0 if mesh.data_rank == 0 else 0.0
    loss_dict = radtts_loss(
        out, batch["input_lengths"], batch["output_lengths"], sigma=sigma,
        n_group_size=model_config["n_group_size"], loss_weights=loss_weights,
        counts=counts, share=share, **configs)
    total = 0.0
    for v, w in loss_dict.values():
        if w > 0:
            total = total + v * w
    w_bin = loss_weights.get("binarization_loss_weight", 1.0)
    if with_bin:
        bin_loss = attention_binarization_loss(
            out["attn"], out["attn_soft"], counts.get("binarization_loss"))
        total = total + bin_loss * w_bin
    else:
        bin_loss = torch.zeros((), device=out["attn_soft"].device)
    loss_dict["binarization_loss"] = (bin_loss, w_bin)
    return total, loss_dict, out


def train_step(model, optimizer, trainable, batch, model_config,
               loss_weights, sigma, binarize, use_kl, grad_clip_val,
               generator=None, use_amp=False, mesh=None, sharded=()):
    """One step in the JAX package's order: the power iteration, forward,
    losses, backward, the clip over the trainable gradients, RAdam.
    use_amp runs the forward's bf16 regions (ops/amp.py), as the JAX
    package's make_train_step wraps its loss; the master weights, the
    gradients and the optimizer stay fp32, with no loss scaler.
    With a mesh (parallel/mesh.py) the batch is this data rank's rows:
    the gradients and the logged losses are summed over the data group
    in one all-reduce, so every rank steps with the global batch's
    gradient; `sharded` names the trainable parameters that hold a
    tensor-parallel shard, whose squared norms the clip sums over the
    model group. Returns (total, loss_dict, grad norm before the clip) as
    tensors, the global batch's with a mesh."""
    spectral_norm_update(model)
    with amp.scope(model, use_amp):
        total, loss_dict, _ = compute_loss(model, batch, model_config,
                                           loss_weights, sigma, binarize,
                                           use_kl, generator, mesh)
    optimizer.zero_grad(set_to_none=True)
    total.backward()
    for p in trainable:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    group = None
    if mesh is not None:
        values = torch.stack([total.detach().float()] + [
            v.detach().float().reshape(()) for v, _ in loss_dict.values()])
        collectives.sum_over([p.grad for p in trainable] + [values],
                             mesh.data_group)
        total = values[0]
        loss_dict = {k: (v, w) for (k, (_, w)), v in zip(loss_dict.items(),
                                                         values[1:])}
        group = mesh.model_group if mesh.n_model > 1 else None
    grad_norm = clip_grad_norm(trainable, grad_clip_val, sharded, group)
    optimizer.step()
    return total.detach(), loss_dict, grad_norm


@torch.no_grad()
def eval_step(model, batch, model_config, loss_weights, sigma):
    """Validation losses under binarized attention, no dropout; returns
    (scalars, attn, attn_soft)."""
    _, loss_dict, out = compute_loss(model, batch, model_config,
                                     loss_weights, sigma, True, False)
    del loss_dict["binarization_loss"]
    return ({k: v for k, (v, _) in loss_dict.items()}, out["attn"],
            out["attn_soft"])


def compute_validation_loss(model, valset, collate_fn, batch_size, device,
                            model_config, loss_weights, sigma, iteration=0,
                            logger=None, train_config=None,
                            sampling_rate=22050, sample_model=None):
    """The validation set's mean losses (reference: train.py:200-297), the
    attention maps to tensorboardX when a logger is given, and with a
    train_config the audio samples it asks for (_log_audio_samples), from
    sample_model where given (the whole model of a tensor-parallel run)."""
    from radtts_tpu_torch.data.dataset import DataLoader

    was_training = model.training
    model.eval()
    loader = DataLoader(valset, batch_size, collate_fn, shuffle=False,
                        drop_last=False)
    totals, n_batches = {}, 0
    attn = attn_soft = last = None
    for batch in loader:
        scalars, attn, attn_soft = eval_step(
            model, batch_to_device(batch, device), model_config,
            loss_weights, sigma)
        for k, v in scalars.items():
            totals[k] = v if k not in totals else totals[k] + v
        n_batches += 1
        last = batch
    model.train(was_training)
    totals = {k: float(v) / max(n_batches, 1) for k, v in totals.items()}
    if logger is not None:
        for k, v in totals.items():
            logger.add_scalar("val/" + k, v, iteration)
        if attn is not None and last is not None:
            name = os.path.basename(last["audiopaths"][0])
            for tag, a in (("attention_weights", attn_soft),
                           ("attention_weights_mas", attn)):
                logger.add_image(tag, _alignment_image(
                    a[0].float().cpu().numpy().T, name), iteration,
                    dataformats="HWC")
        if train_config is not None and last is not None:
            _log_audio_samples(iteration,
                               model if sample_model is None
                               else sample_model,
                               model_config, train_config, last, attn,
                               logger, sampling_rate, device)
    return totals


def _log_audio_samples(iteration, model, model_config, train_config, batch,
                       attn, logger, sampling_rate, device):
    """Synthesize the validation batch's first text through the vocoder of
    train_config (vocoder_checkpoint_path, vocoder_config_path): with the
    ground-truth attributes when log_decoder_samples is set, at attribute
    sigmas 0.1-1.0 when log_attribute_samples is (radtts_tpu/train/
    trainer.py:627-697; reference train.py:247-295). Durations come from
    the MAS map; decoder sigma 0.8, the noise from a generator seeded
    with the iteration. Skipped without both vocoder files; a sigma whose
    synthesis raises is reported and skipped."""
    voc_ckpt = train_config.get("vocoder_checkpoint_path", "")
    voc_cfg = train_config.get("vocoder_config_path", "")
    if not (voc_ckpt and voc_cfg and os.path.exists(voc_ckpt)
            and os.path.exists(voc_cfg)):
        return
    try:
        from radtts_tpu_torch.models.hifigan import denoiser_apply
        from radtts_tpu_torch.models.radtts import (fold_radtts,
                                                    is_attribute_unconditional,
                                                    radtts_infer)
        from radtts_tpu_torch.vocoder_io import load_vocoder

        vocoder, denoiser = load_vocoder(voc_ckpt, voc_cfg, device)
        attribute_sigmas = []
        if train_config.get("log_decoder_samples"):
            attribute_sigmas.append(-1)
        if train_config.get("log_attribute_samples"):
            if is_attribute_unconditional(model.meta):
                attribute_sigmas.extend([1.0])
            else:
                attribute_sigmas.extend([0.1, 0.5, 0.8, 1.0])
        if not attribute_sigmas:
            return
        durations = attn[0].float().sum(0).cpu().numpy()
        durations = np.floor(durations + 0.5).astype(np.int32)
        g = model_config["n_group_size"]
        total = int(durations.sum())
        max_frames = ((total + 16 * g - 1) // (16 * g)) * 16 * g

        def gt_frames(key):
            # the batch's padded T can be shorter than max_frames (a
            # 16*group multiple): zero-padded; frames past `total` are
            # sliced off the mel before the vocoder
            arr = np.asarray(batch[key][:1], np.float32)
            if arr.shape[1] < max_frames:
                arr = np.pad(arr, ((0, 0), (0, max_frames - arr.shape[1])))
            return torch.from_numpy(arr[:, :max_frames]).to(device)

        infer_model = fold_radtts(model)
        speaker = torch.as_tensor(np.asarray(batch["speaker_ids"][:1]),
                                  device=device)
        text = torch.as_tensor(np.asarray(batch["text"][:1]), device=device)
        dur = torch.from_numpy(durations)[None].to(device)
        for attribute_sigma in attribute_sigmas:
            try:
                if attribute_sigma <= 0:
                    kwargs = dict(f0=gt_frames("f0"),
                                  energy_avg=gt_frames("energy_avg"),
                                  voiced_mask=gt_frames("voiced_mask"))
                else:
                    kwargs = dict(sigma_f0=attribute_sigma,
                                  sigma_energy=attribute_sigma)
                with torch.no_grad():
                    out = radtts_infer(
                        infer_model, speaker, text, 0.8, max_frames,
                        dur=dur, generator=torch.Generator(
                            device).manual_seed(iteration), **kwargs)
                    audio = denoiser_apply(
                        denoiser, vocoder(out["mel"][:, :total]),
                        strength=1e-5)
                audio = audio[0].float().cpu().numpy()
                audio = audio / max(np.abs(audio).max(), 1e-5)
                tag = ("decoder_sample_gt_attributes"
                       if attribute_sigma < 0 else
                       f"sample_attribute_sigma_{attribute_sigma}")
                logger.add_audio(tag, audio, iteration, sampling_rate)
            except Exception as exc:  # instability guard (train.py:282-284)
                print("Instability or issue occured during inference, "
                      "skipping sample generation for TB logger", exc)
                continue
    except Exception as exc:
        print("vocoder logging skipped:", exc)


def _alignment_image(alignment, title):
    """An (H, W, 3) uint8 picture of an alignment, through matplotlib when
    it imports (plotting.py of the JAX package), else the map as grey."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        a = alignment - alignment.min()
        a = (255 * a / max(a.max(), 1e-12)).astype(np.uint8)[::-1]
        return np.repeat(a[:, :, None], 3, axis=2)
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.imshow(alignment, aspect="auto", origin="lower",
              interpolation="none")
    ax.set_title(title)
    fig.canvas.draw()
    image = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return image


def prepare_output_folder(output_directory, config):
    """config.json, a tar of the port's sources, and a tensorboardX writer
    where tensorboardX imports (else None)."""
    os.makedirs(output_directory, exist_ok=True)
    with open(os.path.join(output_directory, "config.json"), "w") as f:
        json.dump(config, f, indent=4)
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        with tarfile.open(os.path.join(output_directory, "code.tar.gz"),
                          "w:gz") as tar:
            tar.add(pkg, arcname=os.path.basename(pkg),
                    filter=lambda ti: None if "__pycache__" in ti.name
                    else ti)
    except OSError as exc:
        print("code snapshot skipped:", exc)
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(os.path.join(output_directory, "logs"))


def init_model(model_config, seed, device):
    """The training-form RADTTS, randomly initialised from seed (the
    global generator is left as it was), on device, in train mode."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = RADTTS(model_config, factored=True)
    return model.to(device).train()


def step_generator(device, seed, iteration, data_rank=0):
    """The dropout generator of one step, seeded from (seed, iteration,
    data rank), so that a resumed run draws what the uninterrupted one
    would, the ranks of a model group draw alike (their replicated
    weights stay equal) and data ranks draw apart."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) * 1_000_003 + int(iteration)
                    + int(data_rank) * 2 ** 40)
    return gen


def train(config, output_directory, epochs, optim_algo, learning_rate,
          weight_decay, sigma, iters_per_checkpoint, batch_size, seed,
          checkpoint_path, ignore_layers, ignore_layers_warmstart,
          include_layers, finetune_layers, warmstart_checkpoint_path,
          grad_clip_val, loss_weights, binarization_start_iter=-1,
          kl_loss_start_iter=-1, unfreeze_modules="all", log_interval=1,
          optim_state_dtype="", use_amp=False, profile_dir="",
          profile_start_iter=5, profile_n_iters=5, device=None, mesh=None,
          **kwargs):
    """The training loop (reference: train.py:300-455). use_amp runs each
    step's forward in the bf16 regions (validation stays fp32, as in the
    JAX package); optim_state_dtype "bfloat16" keeps bf16 moments. With a
    profile_dir, a torch.profiler trace (host and, on the card, CUDA
    activity) covers iterations profile_start_iter to profile_start_iter +
    profile_n_iters, as the JAX package's jax.profiler window does
    (radtts_tpu/train/trainer.py:504-512), and is written there as
    trace_<start>_<stop>.json (Chrome trace format). The trace holds the
    port's own spans (tracing.py) as radtts.* ranges: in each step's
    forward the LSTMs' `lstm` runs and their lengths' `readback` and
    `upload` transfers (each a sync); a validation audio sample in the
    window adds radtts_infer's `decode` tree.

    With a mesh (parallel/mesh.py; train/cli.py makes it from the launch
    environment), every rank builds the whole model from the seed, warm
    starts and resumes from unsharded files, then keeps its tensor-parallel
    shard (parallel.shard_model); each data rank loads batch_size rows of
    its own (the loader sharded by data rank over n_data, so the ranks of
    a model group read the same rows), and the step is the global batch's
    (train_step). Every rank validates on the whole validation set, so
    the numbers are a single process's. Rank 0 alone writes the output
    folder, the logs, the profile and the checkpoints, gathered into the
    single-process layout first (parallel.full_train_state).
    Returns a record per step: the iteration, its wall ms (host clock
    around the step and the read-back of its losses, which waits for the
    device), the grad norm and the losses (the global batch's)."""
    from radtts_tpu_torch.data.dataset import (DataCollate, DataLoader,
                                               data_factory)
    from radtts_tpu_torch.parallel import full_train_state, shard_model
    from radtts_tpu_torch.synthesizer import resolve_device

    device = resolve_device(device)
    data_config = config["data_config"]
    model_config = config["model_config"]
    is_rank0 = mesh is None or mesh.is_rank0
    data_rank, n_data = ((0, 1) if mesh is None
                         else (mesh.data_rank, mesh.n_data))
    if seed is None:
        seed = int(hashlib.md5(
            output_directory.encode()).hexdigest(), 16) % 2000
    print(f"Using seed {seed}")

    model = init_model(model_config, seed, device)
    iteration = 0
    if warmstart_checkpoint_path:
        warmstart_state(warmstart_checkpoint_path, model, model_config,
                        include_layers, ignore_layers_warmstart)
        print(f"Warm started from {warmstart_checkpoint_path}")
    mask = build_trainable_mask(model, unfreeze_modules, finetune_layers)
    trainable = apply_trainable_mask(model, mask)
    optimizer = build_optimizer(trainable, optim_algo, learning_rate,
                                weight_decay, optim_state_dtype or None)
    if checkpoint_path:
        meta = load_train_checkpoint(checkpoint_path, model, optimizer,
                                     model_config)
        iteration = meta["iteration"] + 1
        print(f"Loaded checkpoint '{checkpoint_path}' "
              f"(iteration {meta['iteration']})")
    axes = shard_model(model, optimizer, mesh)
    sharded = [p for name, p in model.named_parameters() if name in axes]

    trainset = data_factory(data_config, "training_files")
    valset = data_factory(data_config, "validation_files",
                          trainset.speaker_ids)
    collate_fn = DataCollate()
    train_loader = DataLoader(
        trainset, batch_size, collate_fn, shuffle=True, seed=seed,
        rank=data_rank, world_size=n_data,
        num_worker_procs=int(kwargs.get("num_worker_procs", 0)),
        worker_init=(data_factory, (data_config, "training_files",
                                    trainset.speaker_ids)))
    logger = (prepare_output_folder(output_directory, config) if is_rank0
              else None)

    history = []
    profiler = None
    profile_dir = profile_dir if is_rank0 else ""
    profile_stop = profile_start_iter + profile_n_iters
    epoch_offset = max(0, iteration // max(len(train_loader), 1))
    for epoch in range(epoch_offset, epochs):
        train_loader.set_epoch(epoch)
        if is_rank0:
            print(f"Epoch: {epoch}")
        for batch in train_loader:
            tic = time.perf_counter()
            binarize = iteration >= binarization_start_iter
            use_kl = binarize and iteration >= kl_loss_start_iter
            if profile_dir and iteration == profile_start_iter:
                profiler = start_profiler(device)
            total, loss_dict, grad_norm = train_step(
                model, optimizer, trainable, batch_to_device(batch, device),
                model_config, loss_weights, sigma, binarize, use_kl,
                grad_clip_val,
                step_generator(device, seed, iteration, data_rank),
                use_amp=bool(use_amp), mesh=mesh, sharded=sharded)
            if profiler is not None and iteration == profile_stop:
                stop_profiler(profiler, device, profile_dir,
                              profile_start_iter, profile_stop)
                profiler = None
            # one read-back for every logged scalar
            names = list(loss_dict)
            values = torch.stack([total, grad_norm.to(total.device)]
                                 + [loss_dict[k][0].detach().reshape(())
                                    for k in names]).tolist()
            ms = (time.perf_counter() - tic) * 1e3
            record = {"iteration": iteration, "ms": ms, "total": values[0],
                      "grad_norm": values[1], "binarize": binarize,
                      "use_kl": use_kl, **dict(zip(names, values[2:]))}
            history.append(record)
            if is_rank0 and iteration % max(log_interval, 1) == 0:
                line = [f"iter: {iteration}  ({ms / 1e3:.2f} s)  |  "
                        f"lr: {learning_rate}"]
                for k in names:
                    line.append(f"  |  {k}: {record[k]:.3f}")
                    if logger is not None:
                        logger.add_scalar("train/" + k, record[k], iteration)
                if logger is not None:
                    logger.add_scalar("train/grad_norm", record["grad_norm"],
                                      iteration)
                print("".join(line), flush=True)
            if iteration % iters_per_checkpoint == 0:
                model_sd, optim_sd = full_train_state(model, optimizer, mesh,
                                                      axes)
                sample_model = None
                if is_rank0 and axes:
                    # the audio samples fold the whole model
                    sample_model = RADTTS(model_config, factored=True)
                    sample_model.load_state_dict(model_sd)
                    sample_model.to(device)
                val_losses = compute_validation_loss(
                    model, valset, collate_fn, batch_size, device,
                    model_config, loss_weights, sigma, iteration, logger,
                    train_config=(config["train_config"] if is_rank0
                                  else None),
                    sampling_rate=data_config["sampling_rate"],
                    sample_model=sample_model)
                if is_rank0:
                    path = os.path.join(output_directory,
                                        f"model_{iteration}")
                    save_train_checkpoint(path, model_sd, optim_sd,
                                          iteration, learning_rate)
                    print("Validation loss:", val_losses, flush=True)
                record["validation"] = val_losses
                del model_sd, optim_sd, sample_model
            iteration += 1
    train_loader.close()
    return history


def start_profiler(device):
    """A started torch.profiler over the host and, on the card, CUDA."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    return profiler


def stop_profiler(profiler, device, profile_dir, start, stop):
    """Wait for the device, stop the profiler, write its trace."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    profiler.stop()
    os.makedirs(profile_dir, exist_ok=True)
    profiler.export_chrome_trace(
        os.path.join(profile_dir, f"trace_{start}_{stop}.json"))
    print(f"profiler trace written to {profile_dir}", flush=True)
