"""The host side of the two scan kernels' Hopper designs, on the CPU (the
kernels themselves run only on the card, where chip_smoke.py holds them
against their plain versions): ops/ar_scan.py's planner at the published
AGAP width (alone and as the f0 + energy pair), the resident kernel's
weight images and algorithm emulated in torch against ar_scan_plain, the
multi-problem entry, the paired AGAP decode against the JAX package and
the unpaired path, and ops/mas.py's route and the warp kernel's bit-packed
choices."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from radtts_tpu.models.attributes import ar_step_infer as jax_ar_step_infer
from radtts_tpu.models.radtts import radtts_infer as jax_radtts_infer
from tests.test_torch_gap_models import agap_variant, build, rel, rnd
from tests.test_torch_gap_serve_train import (IN_LENS, SPK, TEXT, gap_config,
                                              jax_params)
from tests.test_torch_synthesizer_parity import np_tree

from radtts_tpu_torch.convert import radtts_from_jax
from radtts_tpu_torch.models import attributes as tattr
from radtts_tpu_torch.models import radtts as port
from radtts_tpu_torch.models.attributes import attribute_model
from radtts_tpu_torch.models.radtts import attribute_config
from radtts_tpu_torch.ops import ar_scan as ar_mod
from radtts_tpu_torch.ops import mas as mas_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def published_step():
    """The scan params of config_ljs_agap.json's first f0 AR step at its
    published width (C=1, H=128, the 128 -> 256 -> 512 -> 1024 -> 1024 ->
    49 spline head); the planner reads shapes only."""
    with open(os.path.join(REPO, "configs", "config_ljs_agap.json")) as f:
        mc = json.load(f)["model_config"]
    torch.manual_seed(0)
    step = attribute_model(attribute_config(mc["f0_model_config"], False),
                           n_speaker_dim=mc["n_speaker_dim"]).flows[0]
    return step.scan_params("tanh")


def check_plan(params, plan, smem_cap=ar_mod.SMEM_CAP):
    """Every unit and row of every segment owned by exactly one block, in
    contiguous slices, and within its block either kept in shared memory
    (the first n_res) or streamed from its overflow image (the others, as
    `streamed` lists them); every block's image within its stride and its
    bytes, state included, within the cap; every block a producer of some
    phase; the producers counted as the kernel waits for them."""
    table, blocks = plan["table"], plan["blocks"]
    streamed = []
    for s, (units, rows, K, _) in enumerate(plan["segments"]):
        starts, counts = table[:, s + 1, 0], table[:, s + 1, 1]
        n_res = table[:, s + 1, 4]
        owned = np.zeros(units, int)
        for a, n in zip(starts, counts):
            owned[a:a + n] += 1
        assert (owned == 1).all()
        assert starts[0] == 0 and (np.diff(starts) == counts[:-1]).all()
        assert ((0 <= n_res) & (n_res <= counts)).all()
        streamed += [(i, s, int(starts[i] + n_res[i]),
                      int(counts[i] - n_res[i]))
                     for i in range(blocks) if counts[i] > n_res[i]]
    assert sorted(streamed) == sorted(plan["streamed"])
    assert plan["split"] == bool(streamed)
    assert (plan["ovf_floats"] <= plan["ovf_stride"]).all()
    assert (plan["img_floats"] <= plan["img_stride"]).all()
    assert plan["smem"] == 4 * (plan["offsets"]["img"] + plan["img_stride"])
    assert plan["smem"] <= smem_cap
    assert (table[:, 1:, 2] % 4 == 0).all() and plan["img_stride"] % 4 == 0
    assert (table[:, 1:, 5] % 4 == 0).all() and plan["ovf_stride"] % 4 == 0
    cnt = table[:, 1:, 1]           # attr, each layer, each head layer
    assert (cnt.sum(1) > 0).all()
    assert plan["producers"] == [
        int((((cnt[:, 0] if p == 0 else 0) + cnt[:, 1 + p]) > 0).sum())
        for p in range(len(plan["segments"]) - 1)]


@pytest.mark.parametrize("blocks", [132, 66])
def test_plan_at_published_width(published_step, blocks):
    """One published AGAP step on 132 and 66 blocks: one resident launch,
    every row owned once, each block within the cap (~60 KB and ~120 KB
    of weights a block)."""
    p = published_step
    # attribute LSTM (its two biases apart), layer 0 without its context
    # half, the head with its biases
    assert ar_mod.weight_bytes(p) == 4 * (66048 + 1024 + 131072 + 1786880
                                          + 2865)
    launches = ar_mod.ar_scan_plan([p], 1, 132, blocks=blocks)
    assert [(lc["route"], lc["problems"], lc["blocks"]) for lc in launches] \
        == [("resident", [0], blocks)]
    plan = launches[0]["plans"][0]
    check_plan(p, plan)
    weights = 4 * plan["img_floats"].max()
    assert 7.9e6 / blocks < weights < 7.9e6 / blocks * 1.25


@pytest.mark.parametrize("B,routes", [
    (1, [("resident", [0, 1])]), (8, [("resident", [0, 1])]),
    (16, [("resident", [0, 1])]),
    (24, [("resident", [0]), ("resident", [1])]),
    (32, [("split", [0]), ("split", [1])]),
    (64, [("split", [0])] * 2 + [("split", [1])] * 2)])
def test_pair_plan(published_step, B, routes):
    """f0 + energy at the published width: one launch on 132 blocks split
    66 / 66 by weight bytes up to B = 16; a launch each where the pair
    does not fit and one does; at B = 32, where one's weights do not fit
    beside its state, a split launch each; at B = 64, where the state alone
    does not fit, a split launch each over each half of the items."""
    p = published_step
    launches = ar_mod.ar_scan_plan([p, p], B, 132)
    assert [(lc["route"], lc["problems"]) for lc in launches] == routes
    for lc in launches:
        assert lc["smem"] <= ar_mod.SMEM_CAP
        for plan in lc["plans"]:
            check_plan(p, plan)
        assert lc["blocks"] == sum(pl["blocks"] for pl in lc["plans"])
    if len(routes) == 1:
        assert [pl["blocks"] for pl in launches[0]["plans"]] == [66, 66]
        assert launches[0]["items"] == [(0, B), (0, B)]
    if B == 64:
        assert [lc["items"] for lc in launches] == [[(0, 32)], [(32, 64)]] * 2


def test_plan_routes_wide_steps_to_the_barrier_kernel():
    """No shape takes the barrier kernel any more: a step whose weights
    exceed every block's shared memory (H = 1024: ~50 MB against 132 x 227
    KB) runs split on the resident kernel, by shape; a smaller cap splits
    the same published step too; H = 18, not a multiple of 4, runs
    resident, padded to 20."""
    assert [lc["route"] for lc in ar_mod.ar_scan_plan(
        [wide_params()], 1, 132)] == ["split"]
    _, mod = build(agap_variant("quadratic"), seed=1)
    small = mod.flows[0].scan_params("tanh")
    assert ar_mod.ar_scan_plan([small], 2, 132)[0]["route"] == "resident"
    assert ar_mod.ar_scan_plan([small], 2, 132, smem_cap=2048)[0][
        "route"] == "split"
    with pytest.raises(ValueError, match="more than the 1024"):
        ar_mod.ar_scan_plan([small], 2, 132, smem_cap=1024)
    # the resident kernel reads activations in float4s: H = 18 is padded
    w = torch.zeros
    odd = dict(wide_params(), attr=(w(72, 1), w(72, 18), (w(72), w(72))),
               lstm=[(w(72, 18), w(72, 18), None)],
               head=[(w(18, 18), w(18), "tanh"), (w(2, 18), w(2), None)])
    assert not ar_mod.resident_widths_ok(odd)
    launch, = ar_mod.ar_scan_plan([odd], 1, 132)
    assert launch["route"] == "resident" and launch["plans"][0]["H"] == 20
    assert [ar_mod.item_group(B) for B in (1, 2, 3, 5, 8, 16, 24)] == [
        1, 2, 4, 8, 8, 8, 8]


def resident_emulation(params, res, cproj, plan):
    """csrc/ar_scan.cu's resident kernel in torch: every weight read from
    the blocks' images through the plan's table (a split plan's units from
    shared memory or the overflow image); the attribute
    LSTM's recurrent product made with layer 0 (the frame before) and
    finished with W_ih_attr . prev and the bias."""
    imgs, ovfs = ar_mod.resident_pack(params, plan, "cpu")
    off, table = plan["offsets"]["img"], plan["table"]
    segs, lds, H, L = plan["segments"], plan["ld"], plan["H"], plan["L"]
    B, T, C = res.shape
    def rows(i, s):
        start, count, w_off, b_off, n_res, ovf_off = (
            int(v) for v in table[i, s])
        _, r, K, biased = segs[s - 1]
        ld = lds[s - 1]
        uf = r * ld
        parts = [imgs[i, w_off - off:w_off - off + n_res * uf],
                 ovfs[i, ovf_off:ovf_off + (count - n_res) * uf]]
        W = torch.cat(parts).reshape(count * r, ld)[:, :K]
        if r == 4:
            ids = (start + torch.arange(count)[:, None]
                   + torch.arange(4)[None, :] * H).reshape(-1)
        else:
            ids = start + torch.arange(count)
        b = imgs[i, b_off - off:b_off - off + count * r] if biased else None
        return ids, W, b

    w_ih_a = imgs[0, :4 * H * C].reshape(4 * H, C)
    b0 = int(table[0, 0, 3]) - off
    b_a = imgs[0, b0:b0 + 4 * H]
    zeros = res.new_zeros(B, H)
    ap, prev, c_a = res.new_zeros(B, 4 * H), res.new_zeros(B, C), zeros
    h, c = [zeros] * L, [zeros] * L
    outs = []
    for t in range(T):
        h_a, c_a = ar_mod._cell(ap + b_a + prev @ w_ih_a.T, c_a)
        x, ap = h_a, res.new_zeros(B, 4 * H)
        for li in range(L):
            gates = res.new_zeros(B, 4 * H)
            for i in range(plan["blocks"]):
                ids, W, b = rows(i, 2 + li)
                g = torch.cat([x, h[li]], 1) @ W.T
                gates[:, ids] = g + (cproj[:, t][:, ids] if li == 0 else b)
                if li == 0:
                    ids, W, _ = rows(i, 1)
                    ap[:, ids] = h_a @ W.T
            h[li], c[li] = ar_mod._cell(gates, c[li])
            x = h[li]
        for k, (_, _, act) in enumerate(params["head"]):
            y = res.new_zeros(B, params["head"][k][0].shape[0])
            for i in range(plan["blocks"]):
                ids, W, b = rows(i, 2 + L + k)
                y[:, ids] = x @ W.T + b
            x = ar_mod._act(y, act)
        prev = ar_mod._head_inverse(params, res[:, t], x)
        outs.append(prev)
    return torch.stack(outs, 1)


@pytest.mark.parametrize("head,layers,blocks", [
    ("quadratic", 1, 5), ("linear", 2, 20), ("affine", 1, 7)])
def test_resident_algorithm_equals_plain(head, layers, blocks):
    """The resident kernel's algorithm over its packed images (blocks that
    own no unit of a layer included) equals ar_scan_plain within 1e-5 *
    max (the same sums, grouped by block)."""
    _, mod = build(agap_variant(head, layers), seed=4)
    step = mod.flows[0]
    ctx, res = torch.from_numpy(rnd((3, 9, 12), 5)), torch.from_numpy(
        rnd((3, 9, 1), 6))
    params, res, cproj = tattr.ar_step_problem(step, res, ctx, "tanh")
    plan = ar_mod.ar_scan_plan([params], 3, 132, blocks=blocks)[0]["plans"][0]
    check_plan(params, plan)
    assert not plan["split"]
    with torch.no_grad():
        want = ar_mod.ar_scan_plain(params, res, cproj)
        got = resident_emulation(params, res, cproj, plan)
    rel(got, want.numpy(), 1e-5)
    assert (want - res).abs().max() > 1e-2
    icfg, fcfg, n_act = ar_mod.resident_config(params, plan, 9, 0)
    assert len(icfg) == ar_mod.RES_INTS
    ld = icfg[ar_mod.RES_SCALARS:ar_mod.RES_SCALARS + ar_mod.MAX_SEGS]
    assert ld[0] == 0 and ld[1:1 + len(plan["ld"])] == plan["ld"]
    assert n_act == 2 * 3 * sum(w.shape[0] for w, _, _ in params["head"])


def wide_params(H=1024):
    """A step whose weights exceed every block's shared memory (H = 1024:
    ~50 MB against 132 x 227 KB; chip_smoke.py:wide_step's shapes)."""
    w = torch.zeros
    return {"attr": (w(4 * H, 1), w(4 * H, H), (w(4 * H), w(4 * H))),
            "lstm": [(w(4 * H, H), w(4 * H, H), None)],
            "head": [(w(H, H), w(H), "tanh"), (w(2, H), w(2), None)],
            "kind": "affine", "scaling_fn": "tanh"}


@pytest.mark.parametrize("H", [1024, 1022, 1023])
def test_split_plan_at_h1024(H):
    """H = 1024 (and 1022 and 1023, padded to 1024) on 132 blocks: one
    split launch; every unit owned once, kept or streamed; each block's
    state and kept rows within the cap; the overflow images hold the rest
    (~32 MB)."""
    launches = ar_mod.ar_scan_plan([wide_params(H)], 1, 132)
    assert [(lc["route"], lc["blocks"]) for lc in launches] == [
        ("split", 132)]
    plan = launches[0]["plans"][0]
    assert plan["H"] == 1024
    check_plan(wide_params(1024), plan)
    kept = 4 * plan["img_floats"].sum()
    streamed = 4 * plan["ovf_floats"].sum()
    assert kept + streamed >= ar_mod.weight_bytes(wide_params(1024))
    assert 30e6 < streamed < 35e6


def agap_width(H, head, layers):
    """agap_variant with the stacked LSTM H wide (a spline head's context,
    the LSTM's output, with it)."""
    cfg = agap_variant(head, layers)
    cfg["hparams"]["n_hidden"] = H
    if cfg["hparams"]["spline_flow_params"] is not None:
        cfg["hparams"]["spline_flow_params"]["n_context_dim"] = H
    return cfg


@pytest.mark.parametrize("H", [16, 10])
def test_pad_widths_is_exact(H):
    """Zero-padded LSTM units and head rows (H = 10 to 12, head widths to
    multiples of 4) leave ar_scan_plain's output as it was, bit for bit;
    H = 16 is returned as it is."""
    _, mod = build(agap_width(H, "quadratic", 2), seed=6)
    ctx, res = torch.from_numpy(rnd((2, 7, 12), 7)), torch.from_numpy(
        rnd((2, 7, 1), 8))
    params, res, cproj = tattr.ar_step_problem(mod.flows[0], res, ctx,
                                               "tanh")
    padded, pproj = ar_mod.pad_widths(params, cproj)
    assert ar_mod.resident_widths_ok(padded)
    assert (padded is params) == (H % 4 == 0)
    assert padded["attr"][1].shape == (4 * ar_mod._pad4(H),
                                       ar_mod._pad4(H))
    assert pproj.shape == (2, 7, 4 * ar_mod._pad4(H))
    with torch.no_grad():
        torch.testing.assert_close(ar_mod.ar_scan_plain(padded, res, pproj),
                                   ar_mod.ar_scan_plain(params, res, cproj),
                                   rtol=0, atol=1e-7)


def test_kernel_params_kept_per_weight_version():
    """kernel_params pads a step once per weight version: the same object
    while the weights stay as they are, a new one after an in-place update
    (with the update in it), and the widened step itself where no width
    needs padding."""
    _, mod = build(agap_width(10, "affine", 1), seed=3)
    params = mod.flows[0].scan_params("tanh")
    first = ar_mod.kernel_params(params)
    assert first["attr"][1].shape == (48, 12)
    assert ar_mod.kernel_params(params) is first
    with torch.no_grad():
        params["head"][0][0].add_(1.0)
    again = ar_mod.kernel_params(params)
    assert again is not first
    torch.testing.assert_close(again["head"][0][0][:10, :10],
                               params["head"][0][0], rtol=0, atol=0)
    _, mod = build(agap_width(16, "affine", 1), seed=3)
    wide = mod.flows[0].scan_params("tanh")
    assert ar_mod.kernel_params(wide)["attr"] == wide["attr"]


@pytest.mark.parametrize("head,layers,H,blocks,cap", [
    ("quadratic", 1, 16, 5, 4096), ("linear", 2, 10, 7, 2560),
    ("affine", 1, 10, 4, 2560), ("quadratic", 2, 18, 3, 9216)])
def test_split_algorithm_equals_plain_and_jax(head, layers, H, blocks, cap):
    """A cap of a few KB splits a small step (H not a multiple of 4 padded
    by pad_widths): the resident kernel's algorithm over the kept rows and
    the overflow images equals ar_scan_plain on the unpadded step
    within 1e-5 * max (the same rows summed in the same order wherever
    they lie), and the JAX package's ar_step_infer within 1e-4 * max."""
    params_j, mod = build(agap_width(H, head, layers), seed=H + layers)
    ctx_np, res_np = rnd((3, 8, 12), 9), rnd((3, 8, 1), 10)
    params, res, cproj = tattr.ar_step_problem(
        mod.flows[0], torch.from_numpy(res_np), torch.from_numpy(ctx_np),
        "tanh")
    launches = ar_mod.ar_scan_plan([params], 3, 132, blocks=blocks,
                                   smem_cap=cap)
    assert [lc["route"] for lc in launches] == ["split"]
    plan = launches[0]["plans"][0]
    padded, pproj = ar_mod.pad_widths(params, cproj)
    check_plan(padded, plan, smem_cap=cap)
    assert plan["streamed"]
    with torch.no_grad():
        want = ar_mod.ar_scan_plain(params, res, cproj)
        got = resident_emulation(padded, res, pproj, plan)
    rel(got, want.numpy(), 1e-5)
    assert (want - res).abs().max() > 1e-2
    jax_out = jax_ar_step_infer(params_j["flows"][0], jnp.asarray(res_np),
                                jnp.asarray(ctx_np), "tanh")
    rel(got, np.asarray(jax_out), 1e-4)


def test_multi_entry_on_cpu_equals_plain_alone():
    """ar_scan_multi on CPU tensors: each problem's ar_scan_plain, no
    launch counted."""
    problems = []
    for seed, head in ((1, "quadratic"), (2, "affine")):
        _, mod = build(agap_variant(head), seed=seed)
        problems.append(tattr.ar_step_problem(
            mod.flows[0], torch.from_numpy(rnd((2, 7, 1), seed)),
            torch.from_numpy(rnd((2, 7, 12), seed + 3)), "tanh"))
    before = (ar_mod.ar_scan.launches, ar_mod.ar_scan.barrier_launches)
    with torch.no_grad():
        outs = ar_mod.ar_scan_multi(problems)
        for out, p in zip(outs, problems):
            torch.testing.assert_close(out, ar_mod.ar_scan_plain(*p),
                                       rtol=0, atol=0)
    assert (ar_mod.ar_scan.launches,
            ar_mod.ar_scan.barrier_launches) == before


def test_paired_agap_decode_matches_jax_and_unpaired(monkeypatch):
    """radtts_infer with AGAP f0 and energy (injected z_f0 / z_energy,
    ragged lengths): the pair runs in lock step, each flow index's two
    steps in one ar_scan_multi call; f0, energy and mel within 1e-4 * max
    of the JAX package and equal to the two models run one after the
    other."""
    cfg = gap_config("agap")
    params = jax_params(cfg)
    model = radtts_from_jax(np_tree(params), cfg)
    dur = np.random.default_rng(1).integers(1, 4, TEXT.shape).astype(
        np.int32)
    dur[1, 8:] = 0
    T = ((int(dur.sum(1).max()) + 31) // 32) * 32
    g, n_mel = cfg["n_group_size"], cfg["n_mel_channels"]
    args = dict(dur=dur, residual=rnd((2, T // g, n_mel * g), 4, 0.8),
                z_f0=rnd((2, T, 1), 2, 0.8), z_energy=rnd((2, T, 1), 3, 0.8),
                in_lens=IN_LENS)
    targs = {k: torch.as_tensor(v) for k, v in args.items()}
    calls = []
    multi = tattr.ar_scan_multi
    monkeypatch.setattr(tattr, "ar_scan_multi",
                        lambda problems: calls.append(len(problems))
                        or multi(problems))
    with torch.no_grad():
        got = port.radtts_infer(model, torch.as_tensor(SPK),
                                torch.as_tensor(TEXT), 0.8, T, **targs)
    n_flows = len(model.f0_pred_module.flows)
    assert calls[-n_flows:] == [2] * n_flows
    ref = jax_radtts_infer(params, jax.random.PRNGKey(1), jnp.asarray(SPK),
                           jnp.asarray(TEXT), 0.8, T,
                           **{k: jnp.asarray(v) for k, v in args.items()})
    for key in ("f0", "energy_avg", "mel"):
        rel(got[key], ref[key])
    monkeypatch.setattr(port, "agap_infer_multi", lambda ms, zs, ts, ss, ln: [
        tattr.agap_infer(m, z, t, s, ln) for m, z, t, s in zip(ms, zs, ts,
                                                                ss)])
    with torch.no_grad():
        alone = port.radtts_infer(model, torch.as_tensor(SPK),
                                  torch.as_tensor(TEXT), 0.8, T, **targs)
    for key in ("f0", "energy_avg", "mel"):
        torch.testing.assert_close(got[key], alone[key], rtol=0, atol=0)


@pytest.mark.parametrize("N,route", [(1, "warp"), (112, "warp"),
                                     (256, "warp"), (257, "warp"),
                                     (600, "warp"), (1024, "warp"),
                                     (1025, "block")])
def test_mas_route_by_tokens(N, route):
    assert mas_mod.mas_route(N) == route


@pytest.mark.parametrize("N,K", [(1, 1), (32, 1), (33, 2), (112, 4),
                                 (256, 8), (257, 16), (300, 16), (512, 16),
                                 (513, 32), (1000, 32), (1024, 32)])
def test_mas_warp_tokens_a_lane(N, K):
    """The warp kernel's template instance by N: the least K of 1, 2, 4,
    8, 16, 32 with 32 K >= N."""
    assert mas_mod.warp_tokens_a_lane(N) == K


def test_mas_warp_route_refuses_long_texts():
    attn = torch.zeros(1, 4, 1100, device="meta")
    with pytest.raises(ValueError, match="N <= 1024"):
        mas_mod.mas_cuda(attn, torch.tensor([4]), torch.tensor([1100]),
                         route="warp")


def warp_emulation(attn, out_lens, in_lens):
    """csrc/mas.cu's warp kernel in numpy float32: lane l holds tokens
    l K .. l K + K - 1, the choices of a frame as 32 lane words (bit q of
    word l: token l K + q), the backtrack reading those bits."""
    B, T, N = attn.shape
    K = mas_mod.warp_tokens_a_lane(N)
    out = np.zeros_like(attn)
    neg = np.float32(-1e30)
    for b in range(B):
        out_len = min(max(out_lens[b], 0), T)
        in_len = min(max(in_lens[b], 0), N)
        words = np.zeros((T, 32), np.uint64)
        with np.errstate(divide="ignore", invalid="ignore"):
            la = np.where(np.arange(32 * K) < in_len,
                          np.log(np.pad(attn[b], ((0, 0), (0, 32 * K - N)),
                                        constant_values=1.0)), neg)
            s = np.full(32 * K, neg, np.float32)
            if in_len > 0:
                s[0] = la[0, 0]
            for i in range(1, out_len):
                sh = np.concatenate([[neg], s[:-1]]).astype(np.float32)
                left = sh >= s
                best = np.where(np.isnan(sh) | np.isnan(s), np.nan,
                                np.maximum(sh, s)).astype(np.float32)
                s = (la[i] + best).astype(np.float32)
                for lane in range(32):
                    words[i, lane] = sum(int(left[lane * K + q]) << q
                                         for q in range(K))
        if out_len > 0 and in_len > 0:
            curr = in_len - 1
            for i in range(out_len - 1, -1, -1):
                if curr < 0:
                    break
                out[b, i, curr] = 1.0
                lane, q = divmod(curr, K)
                if i > 0 and (int(words[i, lane]) >> q) & 1:
                    curr -= 1
            out[b, 0, 0] = 1.0
    return out


@pytest.mark.parametrize("B,T,N,ol,il,ties", [
    (3, 41, 13, [41, 20, 9], [13, 7, 2], False),
    (2, 19, 70, [19, 11], [70, 44], True),
    (2, 30, 112, [30, 0], [112, 5], False),
    (1, 12, 200, [12], [150], False),
    (2, 14, 300, [14, 9], [300, 211], False),
    (1, 10, 300, [10], [300], True),
    (1, 9, 1000, [9], [977], False)])
def test_warp_kernel_algorithm_equals_mas_plain(B, T, N, ol, il, ties):
    """The warp kernel's algorithm (K = 1, 2, 4, 8, 16 and 32 tokens a
    lane, ties, an empty utterance) gives mas_plain's matrix."""
    rng = np.random.default_rng(B * T + N)
    if ties:
        attn = np.full((B, T, N), 1.0 / N, np.float32)
    else:
        logits = rng.normal(size=(B, T, N)) * 3.0
        e = np.exp(logits - logits.max(-1, keepdims=True))
        attn = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    want = mas_mod.mas_plain(torch.from_numpy(attn), torch.as_tensor(ol),
                             torch.as_tensor(il)).numpy()
    np.testing.assert_array_equal(warp_emulation(attn, ol, il), want)


@pytest.mark.parametrize("B,T,N,ol,il", [
    (2, 14, 300, [14, 9], [300, 211]),     # K = 16
    (1, 9, 1000, [9], [977])])             # K = 32
def test_wide_warp_kernel_algorithm_equals_jax(B, T, N, ol, il):
    """Past 256 tokens the warp kernel's algorithm (K = 16 and 32 tokens a
    lane) gives the JAX package's mas_width1 matrix, as mas_plain does."""
    from radtts_tpu.ops.mas import mas_width1

    rng = np.random.default_rng(N + T)
    logits = rng.normal(size=(B, T, N)) * 3.0
    pad = np.arange(N)[None, :] >= np.asarray(il)[:, None]
    logits = np.where(pad[:, None, :], -np.inf, logits)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    attn = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    want = np.asarray(mas_width1(jnp.asarray(attn), jnp.asarray(ol),
                                 jnp.asarray(il)))
    np.testing.assert_array_equal(warp_emulation(attn, ol, il), want)
    np.testing.assert_array_equal(
        mas_mod.mas_plain(torch.from_numpy(attn), torch.as_tensor(ol),
                          torch.as_tensor(il)).numpy(), want)
