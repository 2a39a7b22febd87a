"""Plain twins of the port's decode kernels (adaptive_tpu_torch/ops/
fused_step.py: the cell, greedy and beam-major; the greedy head; the top-W
beam head) against the JAX package's Pallas kernels in interpret mode, on
the same inputs (mirrors tests/test_pallas.py). The CUDA kernels themselves
are held against these twins on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_tpu.ops import attention as jatt
from adaptive_tpu.ops.pallas import fused_step as jfs
from adaptive_tpu_torch.ops import fused_step as tfs
from tests.torch_port_util import port_threads  # noqa: F401


def _cell_inputs(B, K, H, E2, seed=2):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    D = K
    atten = {"affine_v": {"kernel": f(H, D)}, "affine_g": {"kernel": f(H, D)},
             "affine_s": {"kernel": f(H, D)}, "affine_h": {"kernel": f(D, 1)}}
    sentinel = {"affine_x": {"kernel": f(E2, H)}, "affine_h": {"kernel": f(H, H)}}
    lstm = {"w_ih": f(E2, 4 * H), "w_hh": f(H, 4 * H) * 0.2,
            "b_ih": f(4 * H) * 0.1, "b_hh": f(4 * H) * 0.1}
    acts = {"x": f(B, E2), "h": f(B, H), "c": f(B, H), "hp": f(B, H), "V": f(B, K, H)}
    return lstm, atten, sentinel, acts


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def _run_both(B, K, H, E2, jdt, tdt, prepad=False):
    lstm, atten, sentinel, a = _cell_inputs(B, K, H, E2)
    J = lambda tr: _tree(tr, lambda v: jnp.asarray(v, jdt))  # noqa: E731
    T = lambda tr: _tree(tr, lambda v: torch.from_numpy(np.array(v)).to(tdt))  # noqa: E731
    jl, ja, js, jact = J(lstm), J(atten), J(sentinel), J(a)
    jpv = jatt.precompute_slots(ja, jact["V"])
    jV = jact["V"]
    if prepad:
        jV, jpv = jfs.pad_decode_slots(jV, jpv)
    want = jfs.adaptive_decode_cell_fused(
        jl, ja, js, jact["x"], jact["h"], jact["c"], jact["hp"], jV, jpv,
        real_k=K, interpret=True)
    tl, ta, ts, tact = T(lstm), T(atten), T(sentinel), T(a)
    tpv = tact["V"] @ ta["affine_v"]["kernel"]
    got = tfs.adaptive_decode_cell_fused(
        tl, ta, ts, tact["x"], tact["h"], tact["c"], tact["hp"], tact["V"], tpv)
    return got, want


NAMES = ("h", "c", "c_hat", "alpha", "beta")


@pytest.mark.parametrize("B,K,H,E2", [(3, 4, 16, 8), (8, 49, 32, 12)])
def test_cell_twin_matches_pallas_fp32(B, K, H, E2):
    got, want = _run_both(B, K, H, E2, jnp.float32, torch.float32)
    for name, g, w in zip(NAMES, got, want):
        assert tuple(g.shape) == w.shape, name
        assert g.dtype == (torch.float32), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, err_msg=name)


def test_cell_twin_matches_prepadded_pallas():
    """The TPU kernel's 64-lane slot padding (pad_decode_slots + real_k) is
    layout only: the unpadded twin at K = 49 gives the same outputs."""
    got, want = _run_both(5, 49, 32, 12, jnp.float32, torch.float32, prepad=True)
    for name, g, w in zip(NAMES, got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, err_msg=name)


def test_cell_twin_matches_pallas_bf16():
    """bf16 operands: h, c and c_hat come back in bf16 (c is rounded to bf16
    between steps, as in the TPU kernel), alpha and beta in fp32. Stated
    tolerance: 2 bf16 ulps at |v| <= 4 (0.03) for the bf16 outputs, which may
    round apart after fp32 math in another order; 1e-3 for alpha and beta."""
    got, want = _run_both(8, 49, 32, 12, jnp.bfloat16, torch.bfloat16)
    for name, g, w in zip(NAMES, got, want):
        expect = torch.bfloat16 if name in ("h", "c", "c_hat") else torch.float32
        assert g.dtype == expect, name
        atol = 0.03 if expect == torch.bfloat16 else 1e-3
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w.astype(jnp.float32)),
                                   atol=atol, err_msg=name)


def _pad_head(w, b, vocab):
    target = -(-vocab // 128) * 128
    if target > 1280:
        target = -(-target // 1280) * 1280
    return np.pad(w, ((0, 0), (0, target - vocab))), np.pad(b, (0, target - vocab))


@pytest.mark.parametrize("B,H,vocab", [(4, 16, 37), (5, 32, 1500), (6, 16, 2600)])
def test_head_twin_matches_pallas(B, H, vocab):
    rng = np.random.default_rng(5)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    wp, bp = _pad_head(f(H, vocab), f(vocab), vocab)
    chat, h = f(B, H), f(B, H)
    want = jfs.greedy_head_argmax(jnp.asarray(wp), jnp.asarray(bp), jnp.asarray(chat),
                                  jnp.asarray(h), vocab, interpret=True)
    got = tfs.greedy_head_argmax(*map(torch.from_numpy, (wp, bp, chat, h)), vocab)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_head_twin_matches_pallas_bf16():
    """bf16: chat + h is added in bf16, the product accumulates in fp32."""
    rng = np.random.default_rng(6)
    B, H, vocab = 8, 32, 1500
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    wp, bp = _pad_head(f(H, vocab), f(vocab), vocab)
    chat, h = f(B, H), f(B, H)
    want = jfs.greedy_head_argmax(*(jnp.asarray(a, jnp.bfloat16) for a in (wp, bp, chat, h)),
                                  vocab, interpret=True)
    got = tfs.greedy_head_argmax(*(torch.from_numpy(a).bfloat16() for a in (wp, bp, chat, h)),
                                 vocab)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_head_tie_across_chunks_takes_first():
    """A tie between vocab columns 100 and 1400 (two 1280-wide chunks of the
    TPU kernel; two tiles of the CUDA kernel) goes to the first index."""
    H, vocab = 8, 2600
    w = np.zeros((H, vocab), np.float32)
    w[0, 100] = w[0, 1400] = 2.0
    w[0, 2599] = 2.0  # and a third, later
    b = np.zeros(vocab, np.float32)
    wp, bp = _pad_head(w, b, vocab)
    chat = np.full((2, H), 0.5, np.float32)
    h = np.full((2, H), 0.5, np.float32)
    want = jfs.greedy_head_argmax(*map(jnp.asarray, (wp, bp, chat, h)), vocab, interpret=True)
    got = tfs.greedy_head_argmax(*map(torch.from_numpy, (wp, bp, chat, h)), vocab)
    np.testing.assert_array_equal(np.asarray(want), [100, 100])
    np.testing.assert_array_equal(got.numpy(), [100, 100])


def test_head_masks_columns_past_vocab():
    """A padded column with the largest logit never wins (the -1e30 mask)."""
    H, vocab = 4, 37
    w = np.zeros((H, 128), np.float32)
    w[0, 50] = 10.0  # past the real vocab
    w[0, 3] = 1.0
    b = np.zeros(128, np.float32)
    chat = np.ones((1, H), np.float32)
    got = tfs.greedy_head_argmax(*map(torch.from_numpy, (w, b, chat, chat)), vocab)
    assert got.tolist() == [3]


@pytest.mark.parametrize("W", [2, 3, 5])
def test_beam_major_cell_twin_matches_pallas(W):
    """beam_w > 1: rows are batch-major beam copies with their own states,
    V/pv one copy per image. The JAX kernel gets them pre-padded by
    pad_decode_slots, as its beam decoder passes them; the twin unpadded."""
    B, K, H, E2 = 3, 49, 32, 12
    R = B * W
    lstm, atten, sentinel, a = _cell_inputs(R, K, H, E2, seed=11)
    V = a["V"][:B]
    J = lambda tr: _tree(tr, jnp.asarray)  # noqa: E731
    T = lambda tr: _tree(tr, lambda v: torch.from_numpy(np.array(v)))  # noqa: E731
    jl, ja, js = J(lstm), J(atten), J(sentinel)
    jV = jnp.asarray(V)
    jVp, jpvp = jfs.pad_decode_slots(jV, jatt.precompute_slots(ja, jV), beam_w=W)
    want = jfs.adaptive_decode_cell_fused(
        jl, ja, js, *(jnp.asarray(a[n]) for n in ("x", "h", "c", "hp")), jVp, jpvp,
        real_k=K, beam_w=W, interpret=True)
    tl, ta, ts, t = T(lstm), T(atten), T(sentinel), T(a)
    tV = torch.from_numpy(V)
    got = tfs.adaptive_decode_cell_fused(
        tl, ta, ts, t["x"], t["h"], t["c"], t["hp"], tV, tV @ ta["affine_v"]["kernel"],
        beam_w=W)
    for name, g, w in zip(NAMES, got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, err_msg=name)


def test_beam_major_cell_refuses_wrong_row_count():
    """5 rows cannot be 2 images x beam 3: a tiled-V mistake fails loudly,
    as the TPU kernel's check does (tests/test_pallas.py)."""
    z = lambda *s: torch.zeros(s)  # noqa: E731
    atten = {k: {"kernel": z(8, 8)} for k in ("affine_v", "affine_g", "affine_s")}
    atten["affine_h"] = {"kernel": z(8, 1)}
    sentinel = {"affine_x": {"kernel": z(4, 8)}, "affine_h": {"kernel": z(8, 8)}}
    lstm = {"w_ih": z(4, 32), "w_hh": z(8, 32), "b_ih": z(32), "b_hh": z(32)}
    with pytest.raises(ValueError, match="beam-major"):
        tfs.adaptive_decode_cell_fused(lstm, atten, sentinel, z(5, 4), z(5, 8), z(5, 8),
                                       z(5, 8), z(2, 8, 8), z(2, 8, 8), beam_w=3)


@pytest.mark.parametrize("B,H,vocab,W", [(4, 16, 37, 3), (5, 32, 1500, 5), (3, 16, 200, 1)])
def test_beam_head_twin_matches_pallas(B, H, vocab, W):
    """Ids equal (tie order included); topv - lse and lse within 2e-5, as
    tests/test_pallas.py holds the TPU kernel against lax.top_k."""
    rng = np.random.default_rng(11)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    wp, bp = _pad_head(f(H, vocab), f(vocab), vocab)
    chat, h = f(B, H), f(B, H)
    jv, ji, jl = jfs.beam_head_topk(*map(jnp.asarray, (wp, bp, chat, h)), vocab, W,
                                    interpret=True)
    tv, ti, tl = tfs.beam_head_topk(*map(torch.from_numpy, (wp, bp, chat, h)), vocab, W)
    assert ti.dtype == torch.int32 and tv.dtype == tl.dtype == torch.float32
    assert tuple(tv.shape) == (B, W) and tuple(tl.shape) == (B, 1)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose((tv - tl).numpy(), np.asarray(jv - jl), atol=2e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5)


def test_beam_head_tie_order():
    """Equal logits at ids 10 and 40 rank by ascending id, after id 5."""
    H, vocab, W = 8, 64, 4
    w = np.zeros((H, 128), np.float32)
    w[0, [10, 40]] = 2.0
    w[0, 5] = 3.0
    b = np.zeros(128, np.float32)
    chat = np.full((2, H), 0.5, np.float32)
    args = tuple(map(torch.from_numpy, (w, b, chat, chat)))
    _, topi, _ = tfs.beam_head_topk(*args, vocab, W)
    np.testing.assert_array_equal(topi[:, :3].numpy(), [[5, 10, 40]] * 2)
    _, jtopi, _ = jfs.beam_head_topk(*map(jnp.asarray, (w, b, chat, chat)), vocab, W,
                                     interpret=True)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(jtopi))


def test_topk_lower_index_first_keeps_tied_ids_in_order():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0], [0.0, 0.0, 0.0, 0.0, 0.0]])
    v, i = tfs.topk_lower_index_first(x, 3)
    assert i.tolist() == [[1, 2, 4], [0, 1, 2]] and v[0].tolist() == [3.0, 3.0, 3.0]


def test_wrappers_run_twins_on_cpu_without_counting():
    lstm, atten, sentinel, a = _cell_inputs(3, 4, 16, 8)
    T = lambda tr: _tree(tr, lambda v: torch.from_numpy(np.array(v)))  # noqa: E731
    tl, ta, ts, t = T(lstm), T(atten), T(sentinel), T(a)
    pv = t["V"] @ ta["affine_v"]["kernel"]
    gx = (t["x"] @ tl["w_ih"] + tl["b_ih"]).float()
    args = (gx, t["h"], t["c"], t["x"], t["hp"], pv, t["V"], *tfs.cell_operands(tl, ta, ts))
    tfs.reset_launch_counts()
    for g, w in zip(tfs.decode_cell(*args), tfs.decode_cell_plain(*args)):
        assert torch.equal(g, w)
    head = (ta["affine_v"]["kernel"], torch.zeros(4), t["h"], t["c"], 3)
    assert torch.equal(tfs.greedy_head_argmax(*head), tfs.greedy_head_argmax_plain(*head))
    for g, w in zip(tfs.beam_head_topk(*head, 2), tfs.beam_head_topk_plain(*head, 2)):
        assert torch.equal(g, w)
    beam_args = list(args)
    beam_args[5], beam_args[6] = pv[:1], t["V"][:1]  # 3 rows = 1 image x beam 3
    for g, w in zip(tfs.decode_cell(*beam_args, beam_w=3),
                    tfs.decode_cell_plain(*beam_args, beam_w=3)):
        assert torch.equal(g, w)
    assert tfs.decode_cell.launches == 0 and tfs.greedy_head_argmax.launches == 0
    assert tfs.decode_cell.launches_beam == 0 and tfs.beam_head_topk.launches == 0


def test_wrappers_refuse_other_devices():
    meta = torch.empty((2, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfs.greedy_head_argmax(torch.empty((8, 128), device="meta"),
                               torch.empty(128, device="meta"), meta, meta, 10)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfs.decode_cell(*(meta,) * 14)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfs.beam_head_topk(torch.empty((8, 128), device="meta"),
                           torch.empty(128, device="meta"), meta, meta, 10, 3)


@pytest.mark.parametrize("W", [0, 129])
def test_beam_head_refuses_widths_past_one_tile(W):
    """The top-W head takes 1 <= W <= 128 (one vocab tile) on every device."""
    z = torch.zeros((2, 4))
    with pytest.raises(ValueError, match="W="):
        tfs.beam_head_topk(torch.zeros((4, 256)), torch.zeros(256), z, z, 200, W)


# ------------------------- the heads' two instances and their launch plan
@pytest.mark.parametrize("dtype,H,want", [
    (torch.bfloat16, 512, "mma"), (torch.bfloat16, 48, "mma"), (torch.bfloat16, 8, "mma"),
    (torch.bfloat16, 12, "simt"),  # a row of 12 bf16 is no whole number of 16-byte copies
    (torch.bfloat16, 520, "simt"),  # the band's z would not leave room for the ring
    (torch.float32, 512, "simt"), (torch.float32, 48, "simt"),
])
def test_head_instance_rule(dtype, H, want):
    """bf16 with H a multiple of 8 up to 512 takes the tensor-core instance;
    fp32 (exact only on the CUDA cores) and every other H the SIMT one."""
    assert tfs.head_instance(dtype, H) == want


@pytest.mark.parametrize("rows,Vp,W,want", [
    (1024, 10240, 1, (128, 16, 5)),   # greedy main path: 8 bands x 16 splits of 640 columns
    (3072, 10240, 3, (128, 5, 16)),   # beam 3: 24 bands x 5 splits of 2048 columns
    (3072, 10240, 32, (128, 5, 16)),  # the longest list beside a 128-row band
    (3072, 10240, 33, (64, 2, 40)),   # longer lists: 48 bands of 64 rows, 132 // 48 = 2 splits
    (1, 10240, 1, (128, 80, 1)),      # one band: a split a tile
    (3, 128, 5, (128, 1, 1)),         # a vocab shorter than one split
    (1500, 2688, 1, (128, 11, 2)),    # 21 tiles over 132 // 12 = 11 splits, the last holds one
    (40000, 10240, 1, (128, 1, 80)),  # more bands than SMs: one split
])
def test_head_plan_mma_scratch_shapes(rows, Vp, W, want):
    """(band rows, splits = partials a row, tiles a split) for the
    tensor-core instance on 132 SMs; the splits cover every tile once."""
    plan = tfs.head_plan("mma", rows, Vp, W)
    assert tuple(plan) == want
    ntiles = Vp // tfs.HEAD_TILE
    assert (plan.nsplit - 1) * plan.tiles_per_split < ntiles <= plan.nsplit * plan.tiles_per_split


def test_head_plan_follows_the_sm_count_and_simt_keeps_a_partial_a_tile():
    assert tuple(tfs.head_plan("mma", 1024, 10240, 1, sms=64)) == (128, 8, 10)
    assert tuple(tfs.head_plan("simt", 1024, 10240, 3)) == (0, 80, 1)
    assert tuple(tfs.head_plan("simt", 7, 128)) == (0, 1, 1)


@pytest.mark.parametrize("dtype,H,has_t", [(torch.bfloat16, 16, True), (torch.float32, 16, False),
                                           (torch.bfloat16, 12, False)])
def test_prepare_greedy_head_hands_the_kernels_the_transposed_weight(dtype, H, has_t):
    """prepare_greedy_head still unpacks as (w_p [H, Vp], b_p [Vp]); its
    kernel_t is w_p.T in 128 x 64 tiles, contiguous, where head_instance
    picks the tensor-core instance, and None elsewhere."""
    from adaptive_tpu_torch.models import decoders as D

    rng = np.random.default_rng(5)
    vocab, vp = 37, 40
    w = torch.from_numpy(rng.normal(size=(H, vp)).astype(np.float32)).to(dtype)
    b = torch.from_numpy(rng.normal(size=(vp,)).astype(np.float32)).to(dtype)
    spec = D.DecoderSpec("adaptive_attention", 8, H, vocab, padded_vocab=vp)
    head = D.prepare_greedy_head({"adaptive": {"mlp": {"kernel": w, "bias": b}}}, spec)
    w_p, b_p = head
    assert isinstance(head, tfs.PreparedHead) and head[0] is w_p and len(head) == 2
    assert w_p.shape == (H, 128) and b_p.shape == (128,)
    assert torch.equal(w_p[:, :vp], w) and not w_p[:, vp:].any()
    assert (b_p[vocab:] == torch.tensor(tfs.NEG).to(dtype)).all() and torch.equal(b_p[:vocab], b[:vocab])
    if has_t:
        assert head.kernel_t.is_contiguous() and head.kernel_t.shape == (1, 1, 128, 64)
        assert torch.equal(_untile(head.kernel_t, H), w_p.T)
    else:
        assert head.kernel_t is None


def _untile(tiles, H):
    """[Vp / 128, KB, 128, 64] tiles back to W.T [Vp, H], written out from
    the layout's definition: row n of tile [t, kb] holds k = kb * 64 + 8 c
    + e at chunk c ^ (n % 8), element e."""
    nt, kb, _, _ = tiles.shape
    out = torch.zeros((nt * 128, kb * 64), dtype=tiles.dtype)
    for n in range(128):
        for c in range(8):
            out[n::128, (torch.arange(kb) * 64 + 8 * c)[:, None] + torch.arange(8)] = \
                tiles[:, :, n, 8 * (c ^ (n % 8)): 8 * (c ^ (n % 8)) + 8]
    assert not out[:, H:].any()  # k past H is zero-filled
    return out[:, :H]


@pytest.mark.parametrize("H,Vp", [(512, 256), (48, 384), (200, 128), (64, 128)])
def test_head_kernel_tiles_hold_the_transposed_weight_swizzled(H, Vp):
    """Every element of W.T is found where the kernel's descriptors look for
    it, and the k remainder of the last 64-wide block is zero."""
    rng = np.random.default_rng(7)
    w = torch.from_numpy(rng.normal(size=(H, Vp)).astype(np.float32)).bfloat16()
    tiles = tfs.head_kernel_tiles(w)
    assert tiles.shape == (Vp // 128, -(-H // 64), 128, 64) and tiles.is_contiguous()
    assert torch.equal(_untile(tiles, H), w.T)
    # the swizzle itself, on one element: W[k = 9, column 2] is row n = 2 of
    # tile [0, 0], chunk 1 ^ 2 = 3, element 1
    assert tiles[0, 0, 2, 3 * 8 + 1] == w[9, 2]


def test_head_check_refuses_a_tiled_weight_of_another_shape_or_dtype():
    """What _check_head runs for CUDA tensors, reached here with CPU ones:
    the tiled weight must match the [H, Vp] one; fp32 takes none."""
    w = torch.zeros((16, 128), dtype=torch.bfloat16)
    b = torch.zeros(128, dtype=torch.bfloat16)
    z = torch.zeros((4, 16), dtype=torch.bfloat16)
    inst, w_t = tfs._check_head("head", w, b, z, z, 100, None)
    assert inst == "mma" and w_t.shape == (1, 1, 128, 64) and w_t.is_contiguous()
    with pytest.raises(ValueError, match="head_kernel_t has shape"):
        tfs._check_head("head", w, b, z, z, 100, torch.zeros((128, 16), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="head_kernel_t has dtype"):
        tfs._check_head("head", w, b, z, z, 100, torch.zeros((1, 1, 128, 64)))
    with pytest.raises(ValueError, match="head_kernel_t must be contiguous"):
        tfs._check_head("head", w, b, z, z, 100,
                        torch.zeros((1, 1, 64, 128), dtype=torch.bfloat16).transpose(2, 3))
    assert tfs._check_head("head", w.float(), b.float(), z.float(), z.float(), 100, None) \
        == ("simt", None)
