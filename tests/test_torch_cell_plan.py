"""The layout, instance rule and launch plan of the decode cell's tensor-core
instance (adaptive_tpu_torch/ops/fused_step.py: cell_kernel_tiles,
cell_instance, cell_plan) on the CPU. The kernel's arithmetic is emulated
in plain torch over the reordered weights, with the lane map of its
accumulators, and held against the cell's plain twin and against the JAX
package's Pallas cell in interpret mode; prepare_inference carries the
tiles. The CUDA kernel itself is held against the twin on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_tpu.ops import attention as jatt
from adaptive_tpu.ops.pallas import fused_step as jfs
from adaptive_tpu_torch import Config
from adaptive_tpu_torch.decoding.greedy import prepare_cached
from adaptive_tpu_torch.models import build_model
from adaptive_tpu_torch.models import decoders as D
from adaptive_tpu_torch.ops import fused_step as fs
from tests.torch_port_util import port_threads  # noqa: F401

NAMES = ("h", "c", "c_hat", "alpha", "beta")


def _weights(H, E2, K, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32) * scale)
    return {"whh": f(H, 4 * H, scale=H ** -0.5), "bhh": f(4 * H, scale=0.1),
            "wx": f(E2, H, scale=E2 ** -0.5), "whs": f(H, H, scale=H ** -0.5),
            "wg": f(H, K, scale=H ** -0.5), "ws": f(H, K, scale=H ** -0.5),
            "wh": f(K, scale=K ** -0.5), "wv": f(H, K, scale=H ** -0.5)}


def _acts(R, B, H, E2, K, seed=1):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32) * scale)
    return {"gx": f(R, 4 * H), "h": f(R, H, scale=0.5), "c": f(R, H), "x": f(R, E2, scale=0.5),
            "hp": f(R, H, scale=0.5), "V": f(B, K, H).abs()}


def _tiles(w):
    return fs.cell_kernel_tiles(w["whh"], w["wx"], w["whs"], w["wg"], w["ws"])


@pytest.mark.parametrize("H,E2,K", [(64, 64, 49), (128, 64, 7), (512, 512, 49)])
def test_cell_kernel_tiles_rebuild_the_weights(H, E2, K):
    """Read back with the documented maps, the tiles are the weights: row
    32a + 8g + t of whh_t is column g H + 8a + t of w_hh; row u of wsen_t is
    column u of w_x over w_hs; watt_t[kb, j, e] is w_g[8 kb + e, j] and
    watt_t[kb, K + j, e] is w_s[8 kb + e, j]."""
    w = _weights(H, E2, K)
    t = _tiles(w)
    assert [tuple(x.shape) for x in t] == [(4 * H, H), (H, E2 + H), (H // 8, 2 * K, 8)]
    assert all(x.is_contiguous() for x in t)
    order = fs.cell_gate_order(H)
    assert torch.equal(torch.sort(order).values, torch.arange(4 * H))
    for a, g, tt in ((0, 0, 0), (0, 3, 7), (1, 2, 5), (H // 8 - 1, 1, 3)):
        assert order[32 * a + 8 * g + tt] == g * H + 8 * a + tt
        assert torch.equal(t.whh_t[32 * a + 8 * g + tt], w["whh"][:, g * H + 8 * a + tt])
    rebuilt = torch.empty_like(w["whh"])
    rebuilt[:, order] = t.whh_t.t()
    assert torch.equal(rebuilt, w["whh"])
    assert torch.equal(t.wsen_t[:, :E2].t(), w["wx"])
    assert torch.equal(t.wsen_t[:, E2:].t(), w["whs"])
    assert t.watt_t[1, K - 1, 3] == w["wg"][11, K - 1] and t.watt_t[0, K, 7] == w["ws"][7, 0]
    cols = t.watt_t.permute(0, 2, 1).reshape(H, 2 * K)  # [k, column]
    assert torch.equal(cols[:, :K], w["wg"])
    assert torch.equal(cols[:, K:], w["ws"])


def _stage1(a, w, t):
    """Stage 1 as the kernel lays it out: per slice of CELL_UNITS units, the
    slice's gate rows of whh_t and sentinel rows of wsen_t as two products,
    read back through the accumulator map (warp wn, tile jj of its 8-unit
    groups, lane q, element e -> unit u0 + 8 (2 wn + jj) + 2 q + e; gate g in
    gate tile 4 jj + g). Returns the gates [R, 4H] in w_hh's column order
    and the sentinel pre-activation [R, H]."""
    R, H = a["h"].shape
    units = fs.CELL_UNITS
    gates = torch.empty(R, 4 * H)
    pre_s = torch.empty(R, H)
    xin = torch.cat([a["x"], a["hp"]], 1)
    for u0 in range(0, H, units):
        acc_g = a["h"] @ t.whh_t[4 * u0:4 * (u0 + units)].t()  # [R, 4 units]
        acc_s = xin @ t.wsen_t[u0:u0 + units].t()  # [R, units]
        for wn in range(units // 16):
            for jj in range(2):
                for q in range(4):
                    for e in range(2):
                        u = u0 + 8 * (2 * wn + jj) + 2 * q + e
                        for g in range(4):
                            col = 64 * wn + 8 * (4 * jj + g) + 2 * q + e  # in the slice's tile
                            gates[:, g * H + u] = (a["gx"][:, g * H + u] + acc_g[:, col]
                                                   + w["bhh"][g * H + u])
                        pre_s[:, u] = acc_s[:, 16 * wn + 8 * jj + 2 * q + e]
    return gates, pre_s


def _emulated_cell(a, w, t, W):
    """The mma instance's arithmetic in plain fp32: stage 1 through the
    lane map, stage 2 with h' Wg and s Ws over watt_t's k blocks."""
    gates, pre_s = _stage1(a, w, t)
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    cell = torch.sigmoid(f) * a["c"] + torch.sigmoid(i) * torch.tanh(g)
    tc = torch.tanh(cell)
    h_new, s = torch.sigmoid(o) * tc, torch.sigmoid(pre_s) * tc
    K = w["wg"].shape[1]
    cols = t.watt_t.permute(0, 2, 1).reshape(-1, 2 * K)  # watt_t read back by k and column
    ph, sx = h_new @ cols[:, :K], s @ cols[:, K:]
    pv = (a["V"] @ w["wv"]).repeat_interleave(W, 0)
    z = (torch.tanh(pv + ph[:, None, :]) * w["wh"]).sum(-1)
    z_s = (torch.tanh(sx + ph) * w["wh"]).sum(-1, keepdim=True)
    alpha = torch.softmax(z, -1)
    beta = torch.softmax(torch.cat([z, z_s], -1), -1)[:, -1:]
    ctx = torch.bmm(alpha[:, None, :], a["V"].repeat_interleave(W, 0))[:, 0]
    return h_new, cell, beta * s + (1 - beta) * ctx, alpha, beta


def _twin(a, w, W):
    pv = a["V"] @ w["wv"]
    return fs.decode_cell_plain(a["gx"], a["h"], a["c"], a["x"], a["hp"], pv, a["V"], w["whh"],
                                w["bhh"], w["wx"], w["whs"], w["wg"], w["ws"], w["wh"], W)


@pytest.mark.parametrize("H,E2", [(64, 64), (128, 192), (192, 64), (512, 512)])
def test_stage1_epilogue_over_the_tiles_gives_the_twins_preactivations(H, E2):
    """The gates and the sentinel's pre-activation that the lane map puts in
    each thread equal the twin's gx + h W_hh + b_hh and x W_x + h_prev W_hs,
    unit for unit, within fp32 sums in another order (1e-5)."""
    w = _weights(H, E2, 7)
    a = _acts(9, 9, H, E2, 7)
    gates, pre_s = _stage1(a, w, _tiles(w))
    want_g = a["gx"] + a["h"] @ w["whh"] + w["bhh"]
    want_s = a["x"] @ w["wx"] + a["hp"] @ w["whs"]
    torch.testing.assert_close(gates, want_g, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(pre_s, want_s, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("W", [1, 3])
def test_emulated_mma_cell_matches_twin_and_pallas(W):
    """The whole emulated instance (the layout's arithmetic, not the card's
    sums) against the plain twin and the JAX package's Pallas cell in
    interpret mode, fp32, beam-major for W = 3, at the fp32 bound (1e-5)."""
    B, H, E2, K = 3, 64, 64, 49
    w = _weights(H, E2, K, seed=5)
    a = _acts(B * W, B, H, E2, K, seed=6)
    got = _emulated_cell(a, w, _tiles(w), W)
    for name, g, t in zip(NAMES, got, _twin(a, w, W)):
        torch.testing.assert_close(g, t, atol=1e-5, rtol=1e-5, msg=name)
    lstm = {"w_ih": jnp.zeros((E2, 4 * H)), "b_ih": jnp.zeros(4 * H),
            "w_hh": jnp.asarray(w["whh"].numpy()), "b_hh": jnp.asarray(w["bhh"].numpy())}
    atten = {"affine_v": {"kernel": jnp.asarray(w["wv"].numpy())},
             "affine_g": {"kernel": jnp.asarray(w["wg"].numpy())},
             "affine_s": {"kernel": jnp.asarray(w["ws"].numpy())},
             "affine_h": {"kernel": jnp.asarray(w["wh"].numpy())[:, None]}}
    sentinel = {"affine_x": {"kernel": jnp.asarray(w["wx"].numpy())},
                "affine_h": {"kernel": jnp.asarray(w["whs"].numpy())}}
    jV = jnp.asarray(a["V"].numpy())
    jVp, jpvp = jfs.pad_decode_slots(jV, jatt.precompute_slots(atten, jV), beam_w=W)
    # the Pallas cell forms gx = x W_ih + b_ih itself: with both zero, gx = 0
    a0 = dict(a, gx=torch.zeros_like(a["gx"]))
    want = jfs.adaptive_decode_cell_fused(
        lstm, atten, sentinel, *(jnp.asarray(a0[n].numpy()) for n in ("x", "h", "c", "hp")),
        jVp, jpvp, real_k=K, beam_w=W, interpret=True)
    got0 = _emulated_cell(a0, w, _tiles(w), W)
    for name, g, j in zip(NAMES, got0, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=1e-5, err_msg=name)


@pytest.mark.parametrize("dtype,H,E2,want", [
    (torch.bfloat16, 512, 512, "mma"),  # the main path
    (torch.bfloat16, 64, 64, "mma"), (torch.bfloat16, 128, 192, "mma"),
    (torch.bfloat16, 64, 32, "simt"),   # 2E not a whole number of 64-wide K chunks
    (torch.bfloat16, 96, 64, "simt"),   # nor H
    (torch.bfloat16, 100, 512, "simt"), (torch.bfloat16, 16, 8, "simt"),
    (torch.float32, 512, 512, "simt"),  # fp32 stays exact on the CUDA cores
    (torch.float32, 64, 64, "simt"),
])
def test_cell_instance_rule(dtype, H, E2, want):
    assert fs.cell_instance(dtype, H, E2) == want


@pytest.mark.parametrize("rows,W,images,blocks", [
    (1024, 1, 4, (16 * 16, 256)),   # greedy: 4 images a stage-2 block
    (3072, 3, 4, (48 * 16, 256)),   # beam 3: 4 images = 12 rows a stage-2 block
    (9216, 9, 2, (144 * 16, 512)),  # W = 9: 18 rows a stage-2 block
    (1024 * 30, 30, 1, (480 * 16, 1024)),  # one image's beam past 24 rows
    (13, 1, 1, (1 * 16, 13)),       # few rows: one band
    (5000, 1, 19, (79 * 16, 264)),  # more images: 19 a block, at most 24 rows
])
def test_cell_plan_mma(rows, W, images, blocks):
    """Images a stage-2 block on 132 SMs, and the two grids at H 512: stage
    1's bands of 64 rows by slices of 32 units, stage 2's image groups."""
    plan = fs.cell_plan("mma", rows, W)
    assert plan == fs.CellPlan(images)
    assert (fs.CELL_BAND_ROWS, fs.CELL_UNITS) == (64, 32)
    assert (-(-rows // fs.CELL_BAND_ROWS) * (512 // fs.CELL_UNITS),
            -(-(rows // W) // plan.images)) == blocks


def test_cell_plan_simt_and_the_sm_count():
    assert fs.cell_plan("simt", 3072, 3) == fs.CellPlan(0)
    assert fs.cell_plan("simt", 5) == fs.CellPlan(0)
    assert fs.cell_plan("mma", 1024, sms=64).images == 8


def _tiny_cf(dtype, H=64, embed=32, use_pallas="auto"):
    return Config(encoder_backbone="resnet18", train_crop_size=64, vocab_length=37,
                  vocab_pad_multiple=8, adaptive_word_embed_size=embed,
                  adaptive_lstm_hidden_size=H, decode_max_len=4, compute_dtype=dtype,
                  use_pallas=use_pallas)


@pytest.mark.parametrize("dtype,H,embed,use_pallas,has_tiles", [
    ("bfloat16", 64, 32, "auto", True),     # 2E = 64: the mma instance
    ("float32", 64, 32, "auto", False),     # fp32: simt
    ("bfloat16", 32, 16, "auto", False),    # H 32: simt
    ("bfloat16", 64, 32, "never", False),   # no fused kernels at all
])
def test_prepare_inference_carries_the_cell_tiles(dtype, H, embed, use_pallas, has_tiles):
    cf = _tiny_cf(dtype, H, embed, use_pallas)
    model = build_model(cf, device="cpu")
    prepared = model.prepare_inference(model.init(0))
    cell = prepared["cell"]
    if not has_tiles:
        assert cell is None
        return
    dec = prepared["decoder"]
    lstm, adaptive = dec["lstm"], dec["adaptive"]
    want = fs.cell_kernel_tiles(lstm["w_hh"], adaptive["sentinel"]["affine_x"]["kernel"],
                                adaptive["sentinel"]["affine_h"]["kernel"],
                                adaptive["atten"]["affine_g"]["kernel"],
                                adaptive["atten"]["affine_s"]["kernel"])
    assert isinstance(cell, fs.CellTiles)
    for got, exp in zip(cell, want):
        assert got.dtype == torch.bfloat16 and torch.equal(got, exp)
    assert D.prepare_cell_tiles(dec) is not None


def test_prepare_cached_prepares_the_cell_tiles_anew_after_an_in_place_change():
    """An in-place change of W_hh (as an optimiser step makes) misses the
    cache, and the new tiles hold the new weight."""
    cf = _tiny_cf("bfloat16")
    model = build_model(cf, device="cpu")
    net = model.init(0)
    get = prepare_cached(model)
    before = get(net)["cell"].whh_t.clone()
    assert get(net)["cell"].whh_t.data_ptr() == get(net)["cell"].whh_t.data_ptr()
    with torch.no_grad():
        net.decoder.LSTM.weight_hh_l0.mul_(2.0)
    after = get(net)
    assert (get.misses, get.hits) == (2, 2)
    assert not torch.equal(after["cell"].whh_t, before)
    fresh = model.prepare_inference(net)["cell"]
    assert torch.equal(after["cell"].whh_t, fresh.whh_t)
