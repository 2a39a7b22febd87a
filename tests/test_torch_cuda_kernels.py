"""The port's CUDA kernels against their plain twins on the card, at shapes
that chip_smoke.py does not reach: row blocks cut short, beam groups that
straddle blocks, widths below a tile, row counts off the heads' 128-row
bands, top-W lists up to 128, planted ties inside a vocab tile, across two
tiles of a split and across two splits, int8 images of odd sizes and row
counts off the tiles, the conv epilogue's rows off its block steps and the
float encode through it, and the 1x1 conv GEMM's rows off its 128-row tiles
at each tile width and a bf16 encode through it. Each test skips where there
is no card. On a machine with one:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q

(--noconftest: tests/conftest.py sets JAX up, and this file needs no JAX.)
"""

import numpy as np
import pytest
import torch

from adaptive_tpu_torch import Config
from adaptive_tpu_torch.decoding import make_beam_decoder, make_greedy_decoder
from adaptive_tpu_torch.models import build_model
from adaptive_tpu_torch.ops import conv_epilogue as ce
from adaptive_tpu_torch.ops import fused_step as fs

pytestmark = pytest.mark.cuda

# kernel vs twin on the same inputs: fp32 sums in another order; a bf16
# output may round one bf16 step apart after fp32 math in another order
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-5, 2.0 ** -7)}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, *shape, scale=1.0):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale)


def _cell_args(B, H, E2, K, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    D = K
    r = lambda *s, scale=1.0: _randn(rng, *s, scale=scale)  # noqa: E731
    args = [r(B, 4 * H)] + [t.to(dtype) for t in (
        r(B, H, scale=0.5), r(B, H), r(B, E2, scale=0.5), r(B, H, scale=0.5),
        r(B, K, D), r(B, K, H).abs(), r(H, 4 * H, scale=H ** -0.5), r(4 * H, scale=0.1),
        r(E2, H, scale=E2 ** -0.5), r(H, H, scale=H ** -0.5), r(H, D, scale=H ** -0.5),
        r(H, D, scale=H ** -0.5), r(D, scale=D ** -0.5))]
    return [a.to(device).contiguous() for a in args]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,E2,K", [(5, 512, 512, 49), (13, 64, 32, 4), (1, 16, 8, 49),
                                     (130, 128, 64, 49), (1, 64, 64, 3), (1024, 512, 512, 49)])
def test_cell_kernel_matches_twin(cuda, dtype, B, H, E2, K):
    """In bf16, H and E2 multiples of 64 run the mma instance (130 rows end
    two rows into a third 64-row band; 1,024 at the main path's widths);
    the rest, and fp32, the SIMT kernel."""
    args = _cell_args(B, H, E2, K, dtype, cuda)
    fs.reset_launch_counts()
    got = fs.decode_cell(*args)
    torch.cuda.synchronize()
    assert fs.decode_cell.launches == 1
    want = fs.decode_cell_plain(*args)
    for name, g, w in zip(("h", "c", "c_hat", "alpha", "beta"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        atol, rtol = TOL[g.dtype]
        torch.testing.assert_close(g.float(), w.float(), atol=atol, rtol=rtol, msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("W", [2, 3, 5, 9])
@pytest.mark.parametrize("B", [1, 3, 23])
def test_beam_major_cell_kernel_matches_twin(cuda, dtype, W, B):
    """B images x W beam rows: a block of 8 rows holds part of a beam group
    (W = 3, 5, 9) or a short last block. V and pv hold one copy per image."""
    H, E2, K = 64, 32, 49
    args = _cell_args(B * W, H, E2, K, dtype, cuda)
    args[5], args[6] = args[5][:B].contiguous(), args[6][:B].contiguous()
    fs.reset_launch_counts()
    got = fs.decode_cell(*args, beam_w=W)
    torch.cuda.synchronize()
    assert (fs.decode_cell.launches, fs.decode_cell.launches_beam) == (0, 1)
    want = fs.decode_cell_plain(*args, beam_w=W)
    for name, g, w in zip(("h", "c", "c_hat", "alpha", "beta"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        atol, rtol = TOL[g.dtype]
        torch.testing.assert_close(g.float(), w.float(), atol=atol, rtol=rtol, msg=name)


def _check_cell(got, want):
    for name, g, w in zip(("h", "c", "c_hat", "alpha", "beta"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        atol, rtol = TOL[g.dtype]
        torch.testing.assert_close(g.float(), w.float(), atol=atol, rtol=rtol, msg=name)


@pytest.mark.parametrize("W", [1, 2, 3, 5, 9])
@pytest.mark.parametrize("B,H,E2", [(1, 128, 64), (23, 128, 64), (50, 64, 128), (7, 512, 512)])
def test_mma_cell_kernel_matches_twin(cuda, W, B, H, E2):
    """The bf16 tensor-core instance, B images x W beam rows: row counts off
    the 64-row bands (23 x 9 = 207, 50 x 3 = 150), a single image,
    the full widths (H 512, 2E 512), stage-2 blocks of whole images."""
    K = 49
    assert fs.cell_instance(torch.bfloat16, H, E2) == "mma"
    args = _cell_args(B * W, H, E2, K, torch.bfloat16, cuda)
    args[5], args[6] = args[5][:B].contiguous(), args[6][:B].contiguous()
    fs.reset_launch_counts()
    got = fs.decode_cell(*args, beam_w=W)
    torch.cuda.synchronize()
    assert (fs.decode_cell.launches, fs.decode_cell.launches_beam) == ((1, 0) if W == 1 else (0, 1))
    _check_cell(got, fs.decode_cell_plain(*args, beam_w=W))


@pytest.mark.parametrize("W,images", [(1, 1), (1, 5), (3, 2), (3, 8), (9, 1), (2, 12)])
def test_mma_cell_kernel_plans_match_twin(cuda, W, images):
    """Stage-2 groups of one image to 24 rows, each against the twin, on the
    prepared tiles; stages 1 and 2 launched alone give the cell's
    outputs."""
    B, H, E2, K = 29, 128, 64, 49
    args = _cell_args(B * W, H, E2, K, torch.bfloat16, cuda, seed=3)
    args[5], args[6] = args[5][:B].contiguous(), args[6][:B].contiguous()
    tiles = fs.cell_kernel_tiles(*(args[i] for i in (7, 9, 10, 11, 12)))
    plan = fs.CellPlan(images)
    out = fs.decode_cell_run(*args, beam_w=W, cell_t=tiles, plan=plan)
    torch.cuda.synchronize()
    want = fs.decode_cell_plain(*args, beam_w=W)
    _check_cell(out[:5], want)
    apart = [torch.zeros_like(t) for t in out]
    fs.decode_cell_run(*args, beam_w=W, cell_t=tiles, plan=plan, stages=1, out=apart)
    fs.decode_cell_run(*args, beam_w=W, cell_t=tiles, plan=plan, stages=2, out=apart)
    torch.cuda.synchronize()
    for a, b in zip(apart, out):
        assert torch.equal(a, b)


def _head_args(B, H, vocab, dtype, device, seed=1):
    rng = np.random.default_rng(seed)
    vp = -(-vocab // 128) * 128
    w = _randn(rng, H, vp, scale=(2.0 / H) ** 0.5)
    b = _randn(rng, vp, scale=0.1)
    b[vocab:] = fs.NEG
    chat, h = _randn(rng, B, H), _randn(rng, B, H)
    return [t.to(dtype).to(device) for t in (w, b, chat, h)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,vocab", [(70, 48, 1500), (3, 512, 10123), (1, 16, 37),
                                       (129, 48, 1500), (257, 512, 10123), (300, 64, 100)])
def test_head_kernel_matches_twin(cuda, dtype, B, H, vocab):
    """Ids equal, except where the fp32 top-2 logit gap is below 1e-3 (sums
    in another order may then pick the other of two near-equal logits).
    129 and 257 rows end one row into a 128-row band; vocab 100 is shorter
    than one split."""
    w, b, chat, h = _head_args(B, H, vocab, dtype, cuda)
    fs.reset_launch_counts()
    got = fs.greedy_head_argmax(w, b, chat, h, vocab)
    torch.cuda.synchronize()
    assert fs.greedy_head_argmax.launches == 1
    want = fs.greedy_head_argmax_plain(w, b, chat, h, vocab)
    assert got.dtype == torch.int32 and got.shape == (B,)
    logits = (chat + h).to(dtype).float() @ w.float() + b.float()
    logits[:, vocab:] = fs.NEG
    top2 = logits.topk(2, dim=1).values
    near_tie = (top2[:, 0] - top2[:, 1]) < 1e-3
    assert ((got == want) | near_tie).all()
    assert (got < vocab).all()


def test_head_kernel_tie_across_tiles_takes_first(cuda):
    """Equal logits at columns 100, 1400 and 2599 (three vocab tiles of the
    kernel): the first index wins, as jnp.argmax has it."""
    H, vocab = 8, 2600
    w = torch.zeros(H, 2688)
    w[0, [100, 1400, 2599]] = 2.0
    b = torch.zeros(2688)
    b[vocab:] = fs.NEG
    chat = torch.full((3, H), 0.5)
    got = fs.greedy_head_argmax(*(t.to(cuda) for t in (w, b, chat, chat)), vocab)
    assert got.tolist() == [100, 100, 100]


def _tie_columns(cuda, rows, vp, placement):
    """Two columns for equal logits, placed by the plan of the tensor-core
    instance at these rows on this card."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = fs.head_plan("mma", rows, vp, sms=sms)
    assert plan.tiles_per_split >= 2 and plan.nsplit >= 2, plan
    second = {"one_tile": 90, "two_tiles_of_a_split": fs.HEAD_TILE + 10,
              "two_splits": plan.tiles_per_split * fs.HEAD_TILE + 5}[placement]
    return 10, second


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("placement", ["one_tile", "two_tiles_of_a_split", "two_splits"])
def test_head_kernel_tie_placements_take_first(cuda, dtype, placement):
    """Equal logits inside one 128-column tile, in two tiles that one block
    walks over, and in two vocab splits (1500 rows make 12 bands, so a split
    holds 2 of the 21 tiles on 132 SMs): the first index wins in each."""
    H, rows, vocab, vp = 8, 1500, 2600, 2688
    first, second = _tie_columns(cuda, rows, vp, placement)
    w = torch.zeros(H, vp)
    w[0, [first, second]] = 2.0
    b = torch.zeros(vp)
    b[vocab:] = fs.NEG
    chat = torch.full((rows, H), 0.5)
    got = fs.greedy_head_argmax(*(t.to(dtype).to(cuda) for t in (w, b, chat, chat)), vocab)
    assert (got == first).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("placement", ["one_tile", "two_tiles_of_a_split", "two_splits"])
def test_topk_head_kernel_tie_placements_rank_lower_id_first(cuda, dtype, placement):
    """As above for the top-W head: one larger logit at column 700, then the
    tied pair in ascending order, then the zero logits from column 0."""
    H, rows, vocab, vp = 8, 1500, 2600, 2688
    first, second = _tie_columns(cuda, rows, vp, placement)
    w = torch.zeros(H, vp)
    w[0, [first, second]] = 2.0
    w[0, 700] = 3.0
    b = torch.zeros(vp)
    b[vocab:] = fs.NEG
    chat = torch.full((rows, H), 0.5)
    topv, topi, _ = fs.beam_head_topk(*(t.to(dtype).to(cuda) for t in (w, b, chat, chat)),
                                      vocab, 5)
    assert (topi == torch.tensor([700, first, second, 0, 1], device=cuda, dtype=torch.int32)).all()
    assert (topv == torch.tensor([3.0, 2.0, 2.0, 0.0, 0.0], device=cuda)).all()


def _masked_logits(w, b, chat, h, vocab):
    logits = (chat + h).to(w.dtype).float() @ w.float() + b.float()
    logits[:, vocab:] = fs.NEG
    return logits


def _check_topk_against_twin(dtype, W, B, H, vocab, cuda, with_t=False):
    w, b, chat, h = _head_args(B, H, vocab, dtype, cuda)
    fs.reset_launch_counts()
    w_t = fs.head_kernel_tiles(w) if with_t and fs.head_instance(dtype, H) == "mma" else None
    tv, ti, lse = fs.beam_head_topk(w, b, chat, h, vocab, W, head_kernel_t=w_t)
    torch.cuda.synchronize()
    assert fs.beam_head_topk.launches == 1
    rv, ri, rlse = fs.beam_head_topk_plain(w, b, chat, h, vocab, W)
    assert ti.dtype == torch.int32 and tv.shape == ti.shape == (B, W) and lse.shape == (B, 1)
    top = _masked_logits(w, b, chat, h, vocab).sort(dim=1, descending=True).values[:, :W + 1]
    gaps = top[:, :-1] - top[:, 1:]
    near = torch.zeros_like(ti, dtype=torch.bool)
    near[:, :] = gaps < 1e-3
    near[:, 1:] |= gaps[:, :-1] < 1e-3
    assert ((ti == ri) | near).all()
    assert (ti < vocab).all() and (ti >= 0).all()
    same = (ti == ri).all(1)
    torch.testing.assert_close(tv[same], rv[same], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lse, rlse, atol=0, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("W", [1, 3, 5, 9])
@pytest.mark.parametrize("B,H,vocab", [(70, 48, 1500), (3, 512, 10123), (5, 16, 37)])
def test_topk_head_kernel_matches_twin(cuda, dtype, W, B, H, vocab):
    """Top-W ids equal, except where two adjacent fp32 logits of the row lie
    within 1e-3 (sums in another order may swap them); values within fp32
    sum-order tolerance, lse within 1e-5 relative."""
    _check_topk_against_twin(dtype, W, B, H, vocab, cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("W,B,H,vocab", [
    (5, 129, 48, 1500), (9, 257, 512, 10123),  # one row into a 128-row band
    (128, 129, 512, 10123), (128, 70, 48, 1500),  # the longest list: 64-row bands
    (33, 257, 64, 300), (32, 300, 64, 300),  # either side of the band rule
    (32, 129, 512, 10123),  # the most shared memory a block asks for
    (5, 300, 64, 100),  # a vocab shorter than one split
])
def test_topk_head_kernel_odd_rows_and_wide_lists(cuda, dtype, W, B, H, vocab):
    """The same bounds at row counts off the band, at lists up to W = 128
    (past 32 the tensor-core instance runs 64-row bands) and at a vocab of
    one tile; with the tiled weight handed in, as the decoders do."""
    _check_topk_against_twin(dtype, W, B, H, vocab, cuda, with_t=True)


def test_topk_head_kernel_tie_across_tiles_ranks_lower_id_first(cuda):
    """Equal logits at ids 1400, 100 and 2599 (three vocab tiles), one
    larger at 700: the list is 700, then the tied ids in ascending order."""
    H, vocab = 8, 2600
    w = torch.zeros(H, 2688)
    w[0, [100, 1400, 2599]] = 2.0
    w[0, 700] = 3.0
    b = torch.zeros(2688)
    b[vocab:] = fs.NEG
    chat = torch.full((3, H), 0.5)
    _, topi, _ = fs.beam_head_topk(*(t.to(cuda) for t in (w, b, chat, chat)), vocab, 5)
    assert topi[:, :4].tolist() == [[700, 100, 1400, 2599]] * 3
    assert topi[:, 4].tolist() == [0] * 3  # then the zero logits, lowest id first


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    w, b, chat, h = _head_args(4, 16, 37, torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fs.greedy_head_argmax(w, b, chat.T.contiguous().T, h, 37)
    with pytest.raises(ValueError, match="dtype"):
        fs.greedy_head_argmax(w, b, chat.bfloat16(), h, 37)
    with pytest.raises(ValueError, match="multiple"):
        fs.greedy_head_argmax(w[:, :100].contiguous(), b[:100], chat, h, 37)
    with pytest.raises(ValueError, match="W="):
        fs.beam_head_topk(w, b, chat, h, 37, 129)
    with pytest.raises(ValueError, match="dtype"):
        fs.beam_head_topk(w, b.bfloat16(), chat, h, 37, 3)
    wb, bb, cb, hb = (t.bfloat16() for t in (w, b, chat, h))
    with pytest.raises(ValueError, match="head_kernel_t has shape"):
        fs.greedy_head_argmax(wb, bb, cb, hb, 37, head_kernel_t=wb)
    with pytest.raises(ValueError, match="head_kernel_t has dtype"):
        fs.beam_head_topk(wb, bb, cb, hb, 37, 3, head_kernel_t=fs.head_kernel_tiles(w))
    args = _cell_args(4, 16, 8, 4, torch.float32, cuda)
    with pytest.raises(ValueError, match="shape"):
        fs.decode_cell(*args[:6], args[6][:, :3].contiguous(), *args[7:])
    with pytest.raises(ValueError, match="beam-major"):
        fs.decode_cell(*args, beam_w=3)
    args = _cell_args(4, 64, 64, 4, torch.bfloat16, cuda)
    tiles = fs.cell_kernel_tiles(*(args[i] for i in (7, 9, 10, 11, 12)))
    with pytest.raises(ValueError, match="cell_t.wsen_t has shape"):
        fs.decode_cell(*args, cell_t=fs.CellTiles(tiles.whh_t, tiles.whh_t, tiles.watt_t))
    with pytest.raises(ValueError, match="cell_t.whh_t has dtype"):
        fs.decode_cell(*args, cell_t=fs.CellTiles(tiles.whh_t.float(), tiles.wsen_t, tiles.watt_t))
    with pytest.raises(ValueError, match="stage-2 block of one image or more"):
        fs.decode_cell_run(*args, plan=fs.CellPlan(0))


def test_greedy_decode_on_the_card_matches_cpu(cuda):
    """A small model (ResNet-18 at 64 px, H 32) decodes the same fp32 ids on
    the card, through both kernels, as on the CPU through their twins."""
    cf = Config(encoder_backbone="resnet18", train_crop_size=64, vocab_length=37,
                vocab_pad_multiple=8, adaptive_word_embed_size=16,
                adaptive_lstm_hidden_size=32, decode_max_len=8)
    images = np.random.default_rng(2).integers(0, 256, (6, 72, 72, 3), dtype=np.uint8)
    model_g = build_model(cf, device=cuda)
    net_g = model_g.init(0)
    model_c = build_model(cf, device="cpu")
    net_c = model_c.init(0)
    net_c.load_state_dict({k: v.cpu() for k, v in net_g.state_dict().items()})
    fs.reset_launch_counts()
    out_g = make_greedy_decoder(model_g, cf)(net_g, images)
    torch.cuda.synchronize()
    assert fs.decode_cell.launches == fs.greedy_head_argmax.launches == cf.decode_max_len
    out_c = make_greedy_decoder(model_c, cf)(net_c, images)
    np.testing.assert_array_equal(out_g.ids.cpu().numpy(), out_c.ids.numpy())
    torch.testing.assert_close(out_g.attention.cpu(), out_c.attention, atol=2e-4, rtol=0)
    torch.testing.assert_close(out_g.beta.cpu(), out_c.beta, atol=2e-4, rtol=0)


def test_beam_decode_on_the_card_matches_cpu(cuda):
    """A small model decodes the same fp32 beams (W = 3) on the card,
    through the beam-major cell and the top-W head, as on the CPU."""
    cf = Config(encoder_backbone="resnet18", train_crop_size=64, vocab_length=37,
                vocab_pad_multiple=8, adaptive_word_embed_size=16,
                adaptive_lstm_hidden_size=32, decode_max_len=8, beam_size=3)
    images = np.random.default_rng(2).integers(0, 256, (6, 72, 72, 3), dtype=np.uint8)
    model_g = build_model(cf, device=cuda)
    net_g = model_g.init(0)
    model_c = build_model(cf, device="cpu")
    net_c = model_c.init(0)
    net_c.load_state_dict({k: v.cpu() for k, v in net_g.state_dict().items()})
    fs.reset_launch_counts()
    out_g = make_beam_decoder(model_g, cf)(net_g, images)
    torch.cuda.synchronize()
    assert fs.decode_cell.launches_beam == fs.beam_head_topk.launches == cf.decode_max_len
    assert fs.decode_cell.launches == fs.greedy_head_argmax.launches == 0
    out_c = make_beam_decoder(model_c, cf)(net_c, images)
    np.testing.assert_array_equal(out_g.all_ids.cpu().numpy(), out_c.all_ids.numpy())
    torch.testing.assert_close(out_g.all_scores.cpu(), out_c.all_scores, atol=1e-3, rtol=0)
    torch.testing.assert_close(out_g.attention.cpu(), out_c.attention, atol=2e-4, rtol=0)
    torch.testing.assert_close(out_g.beta.cpu(), out_c.beta, atol=2e-4, rtol=0)


# ------------------------------------------------- int8 kernels 5 and 6
def _i8(rng, *shape):
    return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))


def _epilogue_rows(rng, n, k):
    """(scale, bias) fp32 rows that put acc * scale + bias at O(1): an int8
    product of depth k has a spread of ~127^2 sqrt(k) / 3."""
    sc = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32) * 3.0 / (127 ** 2 * k ** 0.5))
    return sc, torch.from_numpy(rng.normal(0, 0.3, n).astype(np.float32))


def _block_args(B, H, W, C, M, device, seed=0):
    rng = np.random.default_rng(seed)
    x, w1, w2, w3 = _i8(rng, B * H * W, C), _i8(rng, M, C), _i8(rng, M, 9 * M), _i8(rng, C, M)
    rows = (*_epilogue_rows(rng, M, C), *_epilogue_rows(rng, M, 9 * M), *_epilogue_rows(rng, C, M))
    return ([t.to(device) for t in (x,)] + [H, W] + [t.to(device) for t in (w1, w2, w3, *rows)]
            + [0.034, 0.057, 0.021, 0.026])


@pytest.mark.parametrize("B,H,W,C,M", [(1, 4, 4, 16, 16), (3, 7, 7, 24, 24), (3, 8, 8, 64, 16),
                                       (1, 7, 7, 16, 64), (3, 4, 8, 24, 64), (2, 13, 5, 64, 24),
                                       (3, 7, 7, 64, 64), (5, 7, 7, 64, 64), (1, 14, 14, 256, 64),
                                       (1, 1, 1, 16, 16), (2, 5, 6, 24, 40), (2, 14, 14, 1024, 256)])
def test_fused_block_kernel_matches_twin(cuda, B, H, W, C, M):
    """Kernel 5 under block_plan's plan against its twin: the same s8
    output, bit for bit (int32 products, the same IEEE epilogue operations;
    the bound allowed is +/-1 quantum on under 0.2% of elements, as on the
    TPU). Also 1x1 images, K % 16 = 8 (C 24, M 40: 8-byte copies) and
    layer3's widths."""
    from adaptive_tpu_torch.ops import fused_block as fb

    args = _block_args(B, H, W, C, M, cuda)
    fb.bottleneck_identity_int8.launches = 0
    got = fb.bottleneck_identity_int8(*args)
    torch.cuda.synchronize()
    assert fb.bottleneck_identity_int8.launches == 1
    want = fb.bottleneck_identity_int8_plain(*args)
    assert got.dtype == torch.int8 and got.shape == want.shape
    assert (want != 0).float().mean() > 0.2  # the epilogue rows keep outputs alive
    d = (got.int() - want.int()).abs()
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) < 2e-3
    assert torch.equal(got, want)


@pytest.mark.parametrize("B,H,W,C,M,rows,images,nt,kt", [
    (5, 7, 7, 64, 64, 7, 2, 128, 128),  # groups of 2, 2, 1: fragments across two images
    (5, 7, 7, 64, 64, 7, 3, 64, 64),  # groups of 3, 2: 147 rows, K chunks of 64
    (5, 7, 7, 64, 64, 3, 1, 128, 128),  # bands of 3, 3, 1 rows
    (1, 14, 14, 256, 64, 2, 1, 64, 128),  # a multi-band image, halo above and below
    (1, 14, 14, 256, 64, 14, 1, 128, 128),  # 196 rows in two passes of 128
    (1, 12, 40, 64, 64, 6, 1, 64, 128),  # 320 stage-1 rows in two passes of 256; one block an SM
    (2, 5, 6, 24, 40, 2, 1, 64, 64),  # 8-byte copies, K tails, short bands
    (3, 4, 4, 16, 16, 4, 3, 128, 128),  # every image in one block, N < a column chunk
    (2, 14, 14, 1024, 256, 14, 1, 128, 128),  # layer3's widths, 181 KB: one block an SM
])
def test_fused_block_kernel_plans_match_twin(cuda, B, H, W, C, M, rows, images, nt, kt):
    """Kernel 5 under plans that block_plan does not pick at these shapes,
    so that each branch of the kernel runs: image groups with a ragged last
    group, bands with a ragged last band, several passes of rows, both
    column chunks, both K chunks, shared bytes past two blocks an SM; bit
    for bit."""
    from adaptive_tpu_torch.ops import fused_block as fb

    args = _block_args(B, H, W, C, M, cuda, seed=3)
    plan = fb.make_plan(B, H, W, C, M, rows, images, nt, kt)
    got = fb._launch_block(plan, args[0], H, W, *args[3:6], args[6:12], *args[12:])
    torch.cuda.synchronize()
    want = fb.bottleneck_identity_int8_plain(*args)
    assert (want != 0).float().mean() > 0.2
    assert torch.equal(got, want)


def _tail_args(N, C, M, M2, device, seed=1):
    rng = np.random.default_rng(seed)
    x, z2, w3, w1 = _i8(rng, N, C), _i8(rng, N, M), _i8(rng, C, M), _i8(rng, M2, C)
    sc3, b3 = _epilogue_rows(rng, C, M)
    sc1, b1 = _epilogue_rows(rng, M2, C)
    return [t.to(device) for t in (x, z2, w3, sc3, b3, w1, sc1, b1)] + [0.024, 0.027, 0.042]


@pytest.mark.parametrize("N,C,M,M2", [(3 * 49, 24, 16, 24), (1 * 16, 16, 64, 16), (3 * 64, 64, 24, 64),
                                      (3 * 49 + 1, 16, 16, 16), (200, 64, 16, 24), (5, 32, 16, 48),
                                      (300, 1024, 256, 512), (200, 2048, 512, 512)])
def test_fused_tail_kernel_matches_twin(cuda, N, C, M, M2):
    """Kernel 6 under tail_plan's plan against its twin: carry and next
    conv1, bit for bit, at row counts that are no multiple of the plan's
    rows and below 16, C = 24 (8-byte copies), M not a multiple of 32 (K
    tails), M2 != M, and layer3's and layer4's widths (layer4's plan holds
    one block an SM)."""
    from adaptive_tpu_torch.ops import fused_tail as ft

    args = _tail_args(N, C, M, M2, cuda)
    ft.tail_conv1_int8.launches = 0
    out, z1 = ft.tail_conv1_int8(*args)
    torch.cuda.synchronize()
    assert ft.tail_conv1_int8.launches == 1
    want_out, want_z1 = ft.tail_conv1_int8_plain(*args)
    assert (want_out != 0).float().mean() > 0.2 and (want_z1 != 0).float().mean() > 0.2
    assert torch.equal(out, want_out) and torch.equal(z1, want_z1)


@pytest.mark.parametrize("N,C,M,M2,rows,nt,kt", [
    (200, 64, 16, 24, 48, 64, 64),  # ragged last block, K chunks of 64, a short K tail
    (5, 32, 16, 48, 16, 128, 128),  # N < 16: one block of 5 rows
    (3 * 49 + 1, 24, 40, 24, 32, 64, 128),  # 8-byte copies, C = 24, M = 40 (K tails)
    (700, 128, 64, 64, 320, 64, 128),  # 320 rows: two passes of 256, the last block ragged
    (700, 128, 64, 128, 160, 128, 128),  # two passes of 128
    (300, 1024, 256, 512, 48, 128, 128),  # layer3's widths into layer4's conv1 (M2 = 2M)
    (300, 1024, 256, 256, 64, 64, 64),  # layer3's widths, column chunks of 64
    (200, 2048, 512, 512, 32, 128, 128),  # layer4's widths, two blocks an SM
    (200, 2048, 512, 512, 64, 128, 128),  # layer4's widths, one block an SM
])
def test_fused_tail_kernel_plans_match_twin(cuda, N, C, M, M2, rows, nt, kt):
    """Kernel 6 under plans that tail_plan does not pick at these shapes, so
    that each branch of the kernel runs: ragged last blocks, several passes
    of rows, both column chunks, both K chunks, both copy widths, shared
    bytes past two blocks an SM; bit for bit."""
    from adaptive_tpu_torch.ops import fused_tail as ft

    args = _tail_args(N, C, M, M2, cuda, seed=4)
    plan = ft.make_tail_plan(N, C, M, M2, rows, nt, kt)
    out, z1 = ft._launch_tail(plan, *args)
    torch.cuda.synchronize()
    want_out, want_z1 = ft.tail_conv1_int8_plain(*args)
    assert (want_out != 0).float().mean() > 0.2 and (want_z1 != 0).float().mean() > 0.2
    assert torch.equal(out, want_out) and torch.equal(z1, want_z1)


def test_tail_launch_refuses_plans_it_does_not_take(cuda):
    """tail_conv1_launch returns cudaErrorInvalidValue (1), and _launch_tail
    raises, for a plan whose shared bytes disagree with its tail_smem, rows
    that are no multiple of 16, a K chunk narrower than the residual tile,
    or 16-byte copies of rows that are not 16-byte multiples."""
    from adaptive_tpu_torch.ops import fused_tail as ft

    args = _tail_args(100, 64, 24, 32, cuda)
    good = ft.make_tail_plan(100, 64, 24, 32, 32, 64, 64)
    for plan in (good._replace(smem=good.smem + 16), good._replace(rows=24),
                 ft.make_tail_plan(100, 64, 24, 32, 32, 128, 64), good._replace(vec=16)):
        with pytest.raises(RuntimeError, match="cudaError_t 1"):
            ft._launch_tail(plan, *args)
    out, z1 = ft._launch_tail(good, *args)
    torch.cuda.synchronize()
    want_out, want_z1 = ft.tail_conv1_int8_plain(*args)
    assert torch.equal(out, want_out) and torch.equal(z1, want_z1)


def test_int8_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from adaptive_tpu_torch.ops import fused_block as fb
    from adaptive_tpu_torch.ops import fused_tail as ft

    args = _block_args(2, 4, 4, 16, 16, cuda)
    bad = list(args)
    bad[0] = args[0].float()
    with pytest.raises(ValueError, match="dtype"):
        fb.bottleneck_identity_int8(*bad)
    bad = list(args)
    bad[6] = args[6].double()  # sc1
    with pytest.raises(ValueError, match="dtype"):
        fb.bottleneck_identity_int8(*bad)
    bad = list(args)
    bad[3] = args[3].T.contiguous().T  # w1, a transposed view
    with pytest.raises(ValueError, match="contiguous"):
        fb.bottleneck_identity_int8(*bad)
    bad = list(args)
    bad[0] = torch.empty(args[0].numel() + 8, dtype=torch.int8, device=cuda)[8:].view(
        args[0].shape)  # 8 bytes off a 16-byte boundary
    with pytest.raises(ValueError, match="16-byte aligned"):
        fb.bottleneck_identity_int8(*bad)
    bad = list(args)
    bad[0] = args[0].cpu()  # x on the CPU picks the twin, which the CUDA weights refuse
    with pytest.raises(ValueError, match="w1 is on cuda"):
        fb.bottleneck_identity_int8(*bad)
    rng = np.random.default_rng(2)
    x, z2, w3, w1 = (t.to(cuda) for t in (_i8(rng, 32, 16), _i8(rng, 32, 8), _i8(rng, 16, 8),
                                          _i8(rng, 8, 16)))
    sc3, b3, sc1, b1 = (t.to(cuda) for t in (*_epilogue_rows(rng, 16, 8), *_epilogue_rows(rng, 8, 16)))
    with pytest.raises(ValueError, match="contiguous"):
        ft.tail_conv1_int8(x, z2.T.contiguous().T, w3, sc3, b3, w1, sc1, b1, 0.1, 0.1, 0.1)
    with pytest.raises(ValueError, match="dtype"):
        ft.tail_conv1_int8(x, z2, w3, sc3.bfloat16(), b3, w1, sc1, b1, 0.1, 0.1, 0.1)
    with pytest.raises(ValueError, match="multiples of 8"):
        ft.tail_conv1_int8(x[:, :12].contiguous(), z2, w3[:12].contiguous(), sc3[:12], b3[:12],
                           w1[:, :12].contiguous(), sc1, b1, 0.1, 0.1, 0.1)


@pytest.mark.parametrize("scheme", ["none", "fused_layers", "fused_tails"])
def test_int8_greedy_decode_on_the_card_matches_cpu(cuda, scheme):
    """A small int8 model (ResNet-50 at 64 px, H 32; per-tensor scales
    calibrated on the card and handed to both) decodes the same fp32 ids on
    the card as on the CPU, with layer3's identity blocks or tails through
    kernel 5 or 6 (launched 5 times) or none. The int8 trunk gives the same
    bits on both; V within 1e-5 (the fp32 heads' sums in another order)."""
    from adaptive_tpu_torch.models.infer import calibrate_model
    from adaptive_tpu_torch.models.resnet import calibrate_bn_
    from adaptive_tpu_torch.ops import fused_block as fb
    from adaptive_tpu_torch.ops import fused_tail as ft
    from adaptive_tpu_torch.ops.preprocess import eval_preprocess

    cf = Config(encoder_backbone="resnet50", train_crop_size=64, vocab_length=37,
                vocab_pad_multiple=8, adaptive_word_embed_size=16,
                adaptive_lstm_hidden_size=32, decode_max_len=8, encoder_quant="int8",
                encoder_quant_granularity="tensor")
    images = np.random.default_rng(2).integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)
    model_g = build_model(cf, device=cuda)
    net_g = model_g.init(0)
    calibrate_bn_(net_g.encoder.resnet_conv, eval_preprocess(torch.as_tensor(images, device=cuda), 64))
    model_g = calibrate_model(model_g, cf, net_g, images)
    kw = {} if scheme == "none" else {f"int8_{scheme}": ("layer3",)}
    model_g = model_g._replace(**kw)
    model_c = build_model(cf, device="cpu")._replace(int8_scales=model_g.int8_scales, **kw)
    net_c = model_c.init(0)
    net_c.load_state_dict({k: v.cpu() for k, v in net_g.state_dict().items()})
    fb.bottleneck_identity_int8.launches = ft.tail_conv1_int8.launches = 0
    feats_g = model_g.encode_inference(model_g.prepare_inference(net_g),
                                       eval_preprocess(torch.as_tensor(images, device=cuda), 64))
    torch.cuda.synchronize()
    launches = (fb.bottleneck_identity_int8.launches, ft.tail_conv1_int8.launches)
    assert launches == {"none": (0, 0), "fused_layers": (5, 0), "fused_tails": (0, 5)}[scheme]
    feats_c = model_c.encode_inference(model_c.prepare_inference(net_c),
                                       eval_preprocess(torch.as_tensor(images), 64))
    torch.cuda.synchronize()
    torch.testing.assert_close(feats_g[0].cpu(), feats_c[0], atol=1e-5, rtol=1e-5)
    out_g = make_greedy_decoder(model_g, cf)(net_g, images)
    out_c = make_greedy_decoder(model_c, cf)(net_c, images)
    np.testing.assert_array_equal(out_g.ids.cpu().numpy(), out_c.ids.numpy())


# ------------------------------------------------- kernel 7, the conv epilogue
def _epilogue_args(rows, C, mode, dtype, device, seed=3):
    """acc, bias, residual, residual_bias of one mode, N(0, 1) values."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g).to(dtype).to(device)  # noqa: E731
    acc, bias = r(rows, C), r(C)
    res = None if mode == "mid" else r(rows, C)
    return acc, bias, res, r(C) if mode == "downsample" else None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["mid", "identity", "downsample"])
@pytest.mark.parametrize("rows,C", [(1, 64), (1001, 64), (200_003, 64), (4099, 256),
                                    (777, 1024), (53, 2048)])
def test_conv_epilogue_kernel_matches_twin(cuda, dtype, mode, rows, C):
    """Row counts that fill no block evenly (a block holds 256 / (C /
    lanes) rows; 200,003 rows of 64 bf16 make 6,251 blocks, the last cut
    short). Equal to the twin: the same adds, one rounding. In fp32 also
    equal to the separate PyTorch passes it replaces (the conv's bias add_,
    the downsample's, z + sc, relu)."""
    acc, bias, res, rb = _epilogue_args(rows, C, mode, dtype, cuda)
    ce.folded_epilogue.launches = 0
    got = ce.folded_epilogue(acc.clone(), bias, res, rb)
    torch.cuda.synchronize()
    assert ce.folded_epilogue.launches == 1
    assert torch.equal(got, ce.folded_epilogue_plain(acc, bias, res, rb))
    if dtype == torch.float32:
        z = acc.clone().add_(bias)
        if res is not None:
            z = z + (res if rb is None else res.clone().add_(rb))
        assert torch.equal(got, torch.relu(z))


def test_conv_epilogue_refuses_what_the_kernel_does_not_take(cuda):
    acc, bias, res, rb = _epilogue_args(64, 64, "downsample", torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="acc must be contiguous"):
        ce.folded_epilogue(acc.T.contiguous().T, bias, res, rb)
    with pytest.raises(ValueError, match="residual must be contiguous"):
        ce.folded_epilogue(acc, bias, res.T.contiguous().T, rb)
    off = torch.empty(acc.numel() + 4, dtype=acc.dtype, device=cuda)[4:].view(acc.shape)
    with pytest.raises(ValueError, match="acc must be 16-byte aligned"):
        ce.folded_epilogue(off, bias, res, rb)  # 8 bytes off a 16-byte boundary
    with pytest.raises(ValueError, match="multiple of 8"):
        ce.folded_epilogue(*_epilogue_args(64, 60, "mid", torch.bfloat16, cuda)[:2])
    with pytest.raises(ValueError, match="multiple of 4"):
        ce.folded_epilogue(*_epilogue_args(64, 6, "mid", torch.float32, cuda)[:2])
    with pytest.raises(ValueError, match="at most 4096"):
        ce.folded_epilogue(*_epilogue_args(4, 4104, "mid", torch.bfloat16, cuda)[:2])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ce.folded_epilogue(acc.half(), bias.half())
    with pytest.raises(ValueError, match="bias has dtype"):
        ce.folded_epilogue(acc, bias.float(), res, rb)
    with pytest.raises(ValueError, match="residual_bias is on cpu"):
        ce.folded_epilogue(acc, bias, res, rb.cpu())


@pytest.mark.parametrize("arch,launches", [("resnet18", 17), ("resnet50", 49)])
def test_float_encode_on_the_card_runs_the_epilogue(cuda, arch, launches):
    """An fp32 encode (TF32 off) launches kernel 7 once for each conv but
    the downsamples, gives the bits of the traversal with biased convs and
    separate passes on the card (the conv without its bias is the same
    cuDNN call; the adds are the same), and the CPU's features within the
    repo's fp32 parity bound."""
    from adaptive_tpu_torch.models import infer

    cf = Config(encoder_backbone=arch, train_crop_size=64, vocab_length=37,
                vocab_pad_multiple=8, adaptive_word_embed_size=16,
                adaptive_lstm_hidden_size=32, decode_max_len=4)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(3, 64, 64, 3)).astype(np.float32))
    model_g = build_model(cf, device=cuda)
    net_g = model_g.init(0)
    model_c = build_model(cf, device="cpu")
    net_c = model_c.init(0)
    net_c.load_state_dict({k: v.cpu() for k, v in net_g.state_dict().items()})
    prepared = model_g.prepare_inference(net_g)
    with torch.no_grad():
        ce.folded_epilogue.launches = 0
        feats_g = model_g.encode_inference(prepared, x.to(cuda))
        torch.cuda.synchronize()
        assert ce.folded_epilogue.launches == launches
        folded, xg = prepared["encoder"]["resnet"], x.to(cuda)
        fused = infer.resnet_apply_folded(folded, xg, arch)
        assert torch.equal(fused, infer._folded_forward(folded, xg, arch, infer._plain_conv))
        feats_c = model_c.encode_inference(model_c.prepare_inference(net_c), x)
    for name, g, c in zip(("V", "v_g", "h0", "c0"), feats_g, feats_c):
        torch.testing.assert_close(g.cpu(), c, atol=2e-4, rtol=0, msg=name)


# -------------------------------- kernel 9, the stride-1 1x1 conv with its epilogue
def _conv1x1_args(M, K, N, mode, device, seed=5):
    """x [M, K], w [N, K, 1, 1] (N(0, 1/K)), bias, residual, residual_bias
    of one mode, bf16 on the device."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=g) * scale).bfloat16().to(device)  # noqa: E731
    x, w, bias = r(M, K), r(N, K, 1, 1, scale=K ** -0.5), r(N)
    res = None if mode == "mid" else r(M, N)
    return x, w, bias, res, r(N) if mode == "downsample" else None


@pytest.mark.parametrize("mode", ["mid", "identity", "downsample"])
@pytest.mark.parametrize("M,K,N", [
    (1, 64, 64), (127, 64, 256), (1000, 256, 64), (3137, 256, 128), (300, 512, 128),
    (4 * 196 + 5, 256, 1024), (129, 1024, 256), (77, 2048, 512), (200, 512, 2048),
    (3 * 49, 128, 512), (513, 192, 192), (260, 64, 1024)])
def test_conv1x1_kernel_matches_twin(cuda, mode, M, K, N):
    """The encode's (K, N) pairs and others at row counts off the 128-row
    tiles (the last tile's rows past M read as zeros and are not written),
    each tile width (N = 192 takes three 64-wide tiles), W resident (N <=
    256 and W up to 128 KB) and streamed: one launch a call, within one bf16
    rounding of the twin (its fp32 product sums in another order)."""
    from adaptive_tpu_torch.ops import conv1x1 as cx

    x, w, bias, res, rb = _conv1x1_args(M, K, N, mode, cuda)
    cx.conv1x1_epilogue.launches = 0
    got = cx.conv1x1_epilogue(x, w, bias, res, rb)
    torch.cuda.synchronize()
    assert cx.conv1x1_epilogue.launches == 1
    assert got.shape == (M, N) and got.dtype == torch.bfloat16
    atol, rtol = TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), cx.conv1x1_epilogue_plain(x, w, bias, res, rb).float(),
                               atol=atol, rtol=rtol)


def test_conv1x1_refuses_what_the_kernel_does_not_take(cuda):
    from adaptive_tpu_torch.ops import conv1x1 as cx

    x, w, bias, res, rb = _conv1x1_args(256, 128, 64, "downsample", cuda)
    with pytest.raises(ValueError, match="takes bfloat16"):
        cx.conv1x1_epilogue(x.float(), w.float(), bias.float(), res.float(), rb.float())
    off = torch.empty(x.numel() + 4, dtype=x.dtype, device=cuda)[4:].view(x.shape)
    with pytest.raises(ValueError, match="x must be 16-byte aligned"):
        cx.conv1x1_epilogue(off, w, bias, res, rb)  # 8 bytes off a 16-byte boundary
    with pytest.raises(ValueError, match="multiples of 64"):
        cx.conv1x1_epilogue(*_conv1x1_args(256, 96, 64, "mid", cuda)[:3])
    with pytest.raises(ValueError, match="multiples of 64"):
        cx.conv1x1_epilogue(*_conv1x1_args(256, 64, 72, "mid", cuda)[:3])
    with pytest.raises(ValueError, match="residual must be contiguous"):
        cx.conv1x1_epilogue(x, w, bias, res.T.contiguous().T, rb)
    with pytest.raises(ValueError, match="bias has dtype"):
        cx.conv1x1_epilogue(x, w, bias.float(), res, rb)
    with pytest.raises(ValueError, match="residual_bias is on cpu"):
        cx.conv1x1_epilogue(x, w, bias, res, rb.cpu())


def test_bf16_encode_on_the_card_runs_kernel_9(cuda):
    """A bf16 ResNet-50 encode launches kernel 9 for each bottleneck's conv1
    and conv3 (32) and kernel 7 for the stem and the conv2s (17); its
    features stay within bf16's reach of the same traversal with every conv
    on cuDNN and kernel 7 (the rounding of each conv's output before its
    epilogue, which kernel 9 leaves out, is the difference)."""
    from adaptive_tpu_torch.models import infer
    from adaptive_tpu_torch.ops import conv1x1 as cx

    cf = Config(encoder_backbone="resnet50", train_crop_size=64, vocab_length=37,
                vocab_pad_multiple=8, adaptive_word_embed_size=16, adaptive_lstm_hidden_size=32,
                decode_max_len=4, compute_dtype="bfloat16")
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(3, 64, 64, 3)).astype(np.float32))
    model = build_model(cf, device=cuda)
    net = model.init(0)
    prepared = model.prepare_inference(net)
    folded, xg = prepared["encoder"]["resnet"], x.to(cuda).bfloat16()

    def separate(name, xx, p, stride, pad, residual=None, residual_p=None):
        z = infer._bias_free_conv(name, xx, p, stride, pad)
        return infer._fused_epilogue(z, p, residual, residual_p)

    with torch.no_grad():
        ce.folded_epilogue.launches = cx.conv1x1_epilogue.launches = 0
        got = infer.resnet_apply_folded(folded, xg, "resnet50")
        torch.cuda.synchronize()
        assert (cx.conv1x1_epilogue.launches, ce.folded_epilogue.launches) == (32, 17)
        want = infer._folded_forward(folded, xg, "resnet50", infer._bias_free_conv, separate)
    rel = float((got.float() - want.float()).norm() / want.float().norm())
    assert rel < 2e-2
