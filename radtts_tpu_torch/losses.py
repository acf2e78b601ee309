"""RADTTS training losses (radtts_tpu/losses.py:17-166): the flow NLL, the
masked regressions of the attribute predictors, the batched attention CTC
and the binarization loss. Layouts: z and log_s channels-last (B, T, C),
masks (B, T). Each returns what the JAX function returns, {name: (value,
weight)} for radtts_loss.

Each term is a sum over the batch's rows divided by a normalizer, a count
of this batch (frames, tokens, items, the hard attention's ones):
loss_counts gives them apart. A data-parallel step sums the counts over
its data group first (one all-reduce) and hands them in as `counts`, so
each rank's terms are its rows' share of the global batch's loss, and the
sum over the ranks is what the JAX package computes on the global batch
(radtts_tpu/losses.py), where a mean of per-rank means would differ
whenever the ranks hold different frame or token counts. The flows'
log-det term, the same on every rank, counts on the rank given share 1
and no other."""

import torch
import torch.nn.functional as F

from radtts_tpu_torch.ops.masking import sequence_mask


def compute_flow_loss(z, log_det_W_list, log_s_list, n_elements, n_dims,
                      mask, sigma=1.0, share=1.0):
    """mask: (B, T, 1) float; n_elements the (global) grouped frames;
    share the part of the log-det term this rank holds. Returns (loss,
    loss_prior)."""
    log_s_total = 0.0
    for log_s in log_s_list:
        log_s_total = log_s_total + (log_s * mask).sum()
    log_det_W_total = 0.0
    if log_det_W_list:
        for log_det_W in log_det_W_list:
            log_det_W_total = log_det_W_total + log_det_W
        log_det_W_total = log_det_W_total * n_elements * share
    z = z * mask
    prior_nll = (z * z).sum() / (2 * sigma * sigma)
    loss = prior_nll - log_s_total - log_det_W_total
    denom = n_elements * n_dims
    return loss / denom, prior_nll / denom


def compute_regression_loss(x_hat, x, mask, name=False, count=None):
    """x_hat: (B, T, C); x: (B, T) or (B, T, C); mask: (B, T, 1) float;
    count the normalizer (default mask.sum())."""
    if x.ndim == 2:
        x = x[:, :, None]
    x = x * mask
    x_hat = x_hat * mask
    if name == "vpred":
        loss = F.binary_cross_entropy_with_logits(x_hat, x, reduction="sum")
    else:
        loss = ((x_hat - x) ** 2).sum()
    return {f"loss_{name}": loss / (mask.sum() if count is None
                                    else count)}


def _attribute_count(model_output, lens, n_group_size):
    """The normalizer's count of an attribute loss: a flow's frames (the
    sum of lens, grouped at use), a DAP's masked frames."""
    if model_output.get("z") is not None:
        return lens.sum()
    return sequence_mask(lens // n_group_size,
                         model_output["x_hat"].shape[1]).sum()


def attribute_prediction_loss(name, model_output, lens, loss_weight,
                              n_group_size=1, sigma=1.0, count=None,
                              share=1.0):
    """(reference: loss.py:74-108): a flow's NLL over its grouped frames
    (with its loss_prior at weight 0), or a DAP's regression; count its
    normalizer's count (default this batch's, _attribute_count)."""
    lens_g = lens // n_group_size
    if count is None:
        count = _attribute_count(model_output, lens, n_group_size)
    if model_output.get("z") is not None:
        z = model_output["z"]
        mask = sequence_mask(lens_g, z.shape[1]).float()[:, :, None]
        n_elements = count // n_group_size
        loss, loss_prior = compute_flow_loss(
            z, model_output["log_det_W_list"], model_output["log_s_list"],
            n_elements, z.shape[-1], mask, sigma, share)
        return {f"loss_{name}": (loss, loss_weight),
                f"loss_prior_{name}": (loss_prior, 0.0)}
    mask = sequence_mask(lens_g, model_output["x_hat"].shape[1])
    mask = mask.float()[:, :, None]
    reg = compute_regression_loss(model_output["x_hat"], model_output["x"],
                                  mask, name, count)
    return {k: (v, loss_weight) for k, v in reg.items()}


def attention_ctc_loss(attn_logprob, in_lens, out_lens, blank_logprob=-1.0,
                       count=None):
    """CTC forcing a monotone pass over every text token, batched:
    classes [blank] + text positions, item b's targets 1..in_lens[b]; the
    classes above in_lens[b] are masked to -1e9 before the log_softmax,
    as the JAX package masks them before optax.ctc_loss's own. Per-item
    losses (infinite ones zeroed) are divided by in_lens, then averaged
    over `count` items (default B). Needs out_lens[b] >= in_lens[b] for a
    finite loss."""
    B, T_mel, T_text = attn_logprob.shape
    logits = torch.cat([attn_logprob.new_full((B, T_mel, 1), blank_logprob),
                        attn_logprob], dim=-1)
    classes = torch.arange(T_text + 1, device=logits.device)
    class_valid = classes[None, :] <= in_lens[:, None]
    logits = logits.masked_fill(~class_valid[:, None, :], -1e9)
    log_probs = F.log_softmax(logits, dim=-1).transpose(0, 1)  # (T, B, K)
    targets = torch.arange(1, T_text + 1, device=logits.device).expand(
        B, T_text)
    per_item = F.ctc_loss(log_probs, targets, out_lens, in_lens, blank=0,
                          reduction="none", zero_infinity=True)
    per_item = per_item / in_lens.to(per_item.dtype)
    return per_item.mean() if count is None else per_item.sum() / count


def attention_binarization_loss(hard_attention, soft_attention, count=None):
    """(reference: loss.py:138-144); count the normalizer (default the
    hard attention's sum)."""
    log_sum = (torch.log(soft_attention.clamp(min=1e-12))
               * hard_attention).sum()
    return -log_sum / (hard_attention.sum() if count is None else count)


def _attribute_terms(model_output, in_lens, out_lens, dur_model_config,
                     f0_model_config, energy_model_config,
                     vpred_model_config, loss_weights):
    """(outputs, name, group size, weight, lengths) of each attribute loss
    the model's outputs hold."""
    attr_cfgs = {
        "duration_model_outputs": ("duration", dur_model_config,
                                   loss_weights.get("dur_loss_weight", 1.0),
                                   in_lens),
        "f0_model_outputs": ("f0", f0_model_config,
                             loss_weights.get("f0_loss_weight", 1.0),
                             out_lens),
        "energy_model_outputs": ("energy", energy_model_config,
                                 loss_weights.get("energy_loss_weight", 1.0),
                                 out_lens),
        "vpred_model_outputs": ("vpred", vpred_model_config,
                                loss_weights.get("vpred_loss_weight", 1.0),
                                out_lens),
    }
    for key, (name, cfg, weight, lens) in attr_cfgs.items():
        mout = model_output.get(key)
        if cfg is None or not mout:
            continue
        g = cfg.get("hparams", {}).get("n_group_size", 1)
        yield mout, name, g, weight, lens


def loss_counts(model_output, in_lens, out_lens, *, dur_model_config=None,
                f0_model_config=None, energy_model_config=None,
                vpred_model_config=None, binarization=False):
    """The normalizers' counts of radtts_loss's terms on this batch, as
    one int64 vector with their names: the mel flow's frames, the CTC's
    items, each attribute loss's (_attribute_count), and with
    binarization the hard attention's ones. Returns (names, counts)."""
    names, counts = [], []
    if model_output.get("z_mel") is not None:
        names.append("loss_mel")
        counts.append(out_lens.sum())
    names.append("loss_ctc")
    counts.append(torch.tensor(in_lens.shape[0], device=in_lens.device))
    for mout, name, g, _, lens in _attribute_terms(
            model_output, in_lens, out_lens, dur_model_config,
            f0_model_config, energy_model_config, vpred_model_config, {}):
        names.append(f"loss_{name}")
        counts.append(_attribute_count(mout, lens, g))
    if binarization:
        names.append("binarization_loss")
        counts.append(model_output["attn"].sum().round())
    return names, torch.stack([c.to(torch.int64) for c in counts])


def radtts_loss(model_output, in_lens, out_lens, *, sigma=1.0,
                n_group_size=1, dur_model_config=None, f0_model_config=None,
                energy_model_config=None, vpred_model_config=None,
                loss_weights=None, counts=None, share=1.0):
    """The aggregate training loss as {name: (value, weight)}
    (reference: loss.py:147-203). counts: {term name: its normalizer's
    count} (loss_counts), summed over a data-parallel group; default this
    batch's. share: this rank's part of the flows' log-det terms."""
    loss_weights = loss_weights or {}
    counts = counts or {}
    loss_dict = {}
    z_mel = model_output.get("z_mel")
    if z_mel is not None:
        n_frames = counts.get("loss_mel", out_lens.sum())
        n_elements = n_frames // n_group_size
        mask = sequence_mask(out_lens // n_group_size, z_mel.shape[1])
        mask = mask.float()[:, :, None]
        loss_mel, loss_prior_mel = compute_flow_loss(
            z_mel, model_output["log_det_W_list"],
            model_output["log_s_list"], n_elements, z_mel.shape[-1], mask,
            sigma, share)
        loss_dict["loss_mel"] = (loss_mel, 1.0)
        loss_dict["loss_prior_mel"] = (loss_prior_mel, 0.0)

    ctc_cost = attention_ctc_loss(
        model_output["attn_logprob"], in_lens, out_lens,
        blank_logprob=loss_weights.get("blank_logprob", -1),
        count=counts.get("loss_ctc"))
    loss_dict["loss_ctc"] = (ctc_cost, loss_weights.get("ctc_loss_weight",
                                                        0.1))
    for mout, name, g, weight, lens in _attribute_terms(
            model_output, in_lens, out_lens, dur_model_config,
            f0_model_config, energy_model_config, vpred_model_config,
            loss_weights):
        loss_dict.update(attribute_prediction_loss(
            name, mout, lens, weight, n_group_size=g,
            count=counts.get(f"loss_{name}"), share=share))
    return loss_dict
