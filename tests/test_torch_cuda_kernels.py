"""The port's CUDA kernels against their plain twins on the card, at shapes
that chip_smoke.py does not reach: row blocks cut short, beam groups that
straddle blocks, widths below a tile, planted ties across vocab tiles. Each
test skips where there is no card. On a machine with one:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q

(--noconftest: tests/conftest.py sets JAX up, and this file needs no JAX.)
"""

import numpy as np
import pytest
import torch

from adaptive_tpu_torch import Config
from adaptive_tpu_torch.decoding import make_beam_decoder, make_greedy_decoder
from adaptive_tpu_torch.models import build_model
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
@pytest.mark.parametrize("B,H,E2,K", [(5, 512, 512, 49), (13, 64, 32, 4), (1, 16, 8, 49)])
def test_cell_kernel_matches_twin(cuda, dtype, B, H, E2, K):
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


def _head_args(B, H, vocab, dtype, device, seed=1):
    rng = np.random.default_rng(seed)
    vp = -(-vocab // 128) * 128
    w = _randn(rng, H, vp, scale=(2.0 / H) ** 0.5)
    b = _randn(rng, vp, scale=0.1)
    b[vocab:] = fs.NEG
    chat, h = _randn(rng, B, H), _randn(rng, B, H)
    return [t.to(dtype).to(device) for t in (w, b, chat, h)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,vocab", [(70, 48, 1500), (3, 512, 10123), (1, 16, 37)])
def test_head_kernel_matches_twin(cuda, dtype, B, H, vocab):
    """Ids equal, except where the fp32 top-2 logit gap is below 1e-3 (sums
    in another order may then pick the other of two near-equal logits)."""
    w, b, chat, h = _head_args(B, H, vocab, dtype, cuda)
    got = fs.greedy_head_argmax(w, b, chat, h, vocab)
    torch.cuda.synchronize()
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


def _masked_logits(w, b, chat, h, vocab):
    logits = (chat + h).to(w.dtype).float() @ w.float() + b.float()
    logits[:, vocab:] = fs.NEG
    return logits


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("W", [1, 3, 5, 9])
@pytest.mark.parametrize("B,H,vocab", [(70, 48, 1500), (3, 512, 10123), (5, 16, 37)])
def test_topk_head_kernel_matches_twin(cuda, dtype, W, B, H, vocab):
    """Top-W ids equal, except where two adjacent fp32 logits of the row lie
    within 1e-3 (sums in another order may swap them); values within fp32
    sum-order tolerance, lse within 1e-5 relative."""
    w, b, chat, h = _head_args(B, H, vocab, dtype, cuda)
    fs.reset_launch_counts()
    tv, ti, lse = fs.beam_head_topk(w, b, chat, h, vocab, W)
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
    args = _cell_args(4, 16, 8, 4, torch.float32, cuda)
    with pytest.raises(ValueError, match="shape"):
        fs.decode_cell(*args[:6], args[6][:, :3].contiguous(), *args[7:])
    with pytest.raises(ValueError, match="beam-major"):
        fs.decode_cell(*args, beam_w=3)


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
