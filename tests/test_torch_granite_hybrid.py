"""The granite_h_micro caption decoder (adaptive_tpu_torch/models/hybrid_lm.py)
at a tiny size on the CPU against the plain reference (tests/
plain_granite_hybrid.py, float32): hidden 64, layers mamba, mamba,
attention, mamba, 4 Mamba heads of 16 with d_state 16, 4 query and 2 KV
heads, a vocabulary of 96, on a ResNet-50 trunk at 64 px. Also kernel 8's
twin and checks, the variant's refusals, and (marked cuda, skipping where
there is no card) kernel 8 against its twin at the cell's widths:
    python -m pytest --noconftest -m cuda tests/test_torch_granite_hybrid.py -q
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from adaptive_tpu_torch.config import Config
from adaptive_tpu_torch.decoding import make_beam_decoder, make_greedy_decoder
from adaptive_tpu_torch.models.factory import build_model
from adaptive_tpu_torch.ops import ssd
from adaptive_tpu_torch.ops import ssm_step as SS
from adaptive_tpu_torch.ops.preprocess import eval_preprocess
from benchmark.lib.images import seeded_images
from benchmark.reference.compare import logit_gap
from benchmark.reference.model import calibrate_bn
from plain_granite_hybrid import HybridReference, make_weights

ROOT = Path(__file__).resolve().parent.parent
LM = {"hidden_size": 64, "shared_intermediate_size": 128,
      "layer_types": ["mamba", "mamba", "attention", "mamba"], "num_attention_heads": 4,
      "num_key_value_heads": 2, "mamba_n_heads": 4, "mamba_d_head": 16, "mamba_d_state": 16,
      "mamba_expand": 1}
PUBLISHED_REST = {"mamba_n_groups": 1, "mamba_d_conv": 4, "attention_multiplier": 0.015625,
                  "embedding_multiplier": 12.0, "residual_multiplier": 0.22,
                  "logits_scaling": 8.0, "rms_norm_eps": 1e-5}
KNOBS = {"atten_model_name": "granite_h_micro", "encoder_backbone": "resnet50",
         "train_crop_size": 64, "resized_image_size": 72, "vocab_length": 96,
         "decode_max_len": 6, "eval_batch_size": 3}
B, T = 3, 6
# float32 against float32: sums in another order (fused q/k/v, the chunked
# scan against the recurrence, the trunk's folded BN) leave ~1e-7 relative
REL = 1e-5


def rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


@pytest.fixture(scope="module")
def tiny():
    torch.manual_seed(0)
    cfg = dict(KNOBS, **LM, **PUBLISHED_REST)
    w = make_weights(cfg, 3, "cpu")
    images = seeded_images(B, 4, 72, "cpu")
    calibrate_bn(w, cfg, images)
    cf = Config(**KNOBS, hybrid_lm=dict(LM, mamba_chunk_size=3))
    model = build_model(cf, device="cpu")
    net = model.new_net()
    net.load_state_dict(w, strict=True)
    prepared = model.prepare_inference(net)
    ref = HybridReference(w, cfg)
    (A,) = model.encode_inference(prepared, eval_preprocess(images, 64, torch.float32))
    return {"cfg": cfg, "cf": cf, "w": w, "images": images, "model": model, "net": net,
            "prepared": prepared, "ref": ref, "A": A,
            "tokens": ref.image_tokens(ref.trunk_map(images))}


def test_prefill_and_cached_decode_match_the_reference_forward(tiny):
    """The image tokens, then every position's logits of a prefill and T
    cached steps (the 4 image tokens' scan in chunks of 3, its states
    carried into the steps) against the reference's one pass."""
    model, prepared = tiny["model"], tiny["prepared"]
    assert rel(model.image_tokens(prepared, tiny["A"]), tiny["tokens"]) < REL
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 96, (B, T)))
    want = tiny["ref"].logits(tiny["tokens"], ids)
    cache = model.prefill(prepared, tiny["A"], T)
    got = torch.stack([model.step(prepared, ids[:, t], cache) for t in range(T)], dim=1)
    assert cache.pos == tiny["A"].shape[1] + T
    for t in range(T):
        assert rel(got[:, t], want[:, t]) < REL, t


@pytest.mark.parametrize("chunk,L", [(256, 7), (3, 7), (4, 4)])
def test_chunked_prefill_states_match_the_recurrence(chunk, L):
    """ops/ssd.py's conv and chunked scan against L steps of the
    recurrence (kernel 8's twin) from zero states: outputs, the final SSM
    state and conv state."""
    g = torch.Generator().manual_seed(chunk + L)
    H, P, N, G, K = 4, 8, 16, 2, 4
    C = H * P + 2 * G * N
    xbc = torch.randn(2, L, C, generator=g)
    dt = torch.randn(2, L, H, generator=g)
    w, b = torch.rand(C, K, generator=g) - 0.5, torch.rand(C, generator=g) - 0.5
    dt_bias, A, D = torch.randn(H, generator=g) - 3, -torch.rand(H, generator=g) * 8 - 1, \
        torch.rand(H, generator=g) + 0.5
    act, conv = ssd.causal_conv(xbc, w, b)
    x, Bm, Cm = act.split([H * P, G * N, G * N], dim=-1)
    y, state = ssd.ssd_prefill(x.reshape(2, L, H, P),
                               torch.nn.functional.softplus(dt + dt_bias), A,
                               Bm.reshape(2, L, G, N), Cm.reshape(2, L, G, N), D, chunk)
    S, cs = torch.zeros(2, H, P, N), torch.zeros(2, K - 1, C)
    for t in range(L):
        yt, cs, S = SS.ssm_step_plain(xbc[:, t], dt[:, t], cs, w, b, dt_bias, A, D, S)
        assert rel(y[:, t].reshape(2, H * P), yt) < REL, t
    assert rel(state, S) < REL and torch.equal(conv, cs)


def test_kernel_twin_is_one_step_of_the_reference(tiny):
    """A Mamba layer's prefill of L positions and one decode step through
    ssm_step (its twin here) against the reference layer's one pass of
    L + 1 positions, at its last."""
    model, prepared, ref = tiny["model"], tiny["prepared"], tiny["ref"]
    L = 5
    x = torch.randn(B, L + 1, 64, generator=torch.Generator().manual_seed(2))
    want = ref.mamba(x, "lm.model.layers.1.mamba")[:, -1]
    from adaptive_tpu_torch.models.hybrid_lm import HybridCache

    cache = HybridCache(model.lm, B, L + 1, torch.float32, "cpu")
    p = prepared["lm"]["layers"][1]
    model._mamba_prefill(p, x[:, :L], cache, 1)
    launches = SS.ssm_step.launches
    got = model._mamba_step(p, x[:, L], cache, 1)
    assert rel(got, want) < REL and SS.ssm_step.launches == launches  # the twin: no launch


def test_greedy_decoder_serves_the_references_greedy_ids(tiny):
    """make_greedy_decoder's ids: each served token's reference logit is
    within 1e-4 of the reference's best (float32 sums in another order can
    reorder near-ties); no attention maps or sentinel shares."""
    out = make_greedy_decoder(tiny["model"], tiny["cf"])(tiny["net"], tiny["images"])
    assert out.ids.shape == (B, T) and out.ids.dtype == torch.int32
    assert out.attention.shape == (B, T, 0) and out.beta.shape == (B, 0)
    logits = tiny["ref"].served_logits(tiny["tokens"], out.ids.long(), 1)
    assert logit_gap(logits, out.ids, [T] * B) <= 1e-4


class Words:
    """A vocabulary of 96 words (data/vocab.py::Vocabulary's interface that
    CaptionService reads)."""

    def __len__(self):
        return 96

    def decode_ids(self, ids):
        return " ".join(f"w{int(i)}" for i in ids)


def test_caption_service_serves_the_decoders_captions(tiny):
    from adaptive_tpu_torch.serving import CaptionService

    vocab = Words()
    service = CaptionService(tiny["cf"], vocab, net=tiny["net"], batch_size=B, device="cpu")
    try:
        reply = service.caption(tiny["images"][0].numpy())
    finally:
        service.close()
    ids = make_greedy_decoder(tiny["model"], tiny["cf"])(tiny["net"], tiny["images"]).ids
    assert reply["caption"] == vocab.decode_ids(ids[0].numpy()) and reply["beta"] == []


def test_out_of_scope_paths_raise(tiny, tmp_path):
    from adaptive_tpu_torch.export import export_decoder
    from adaptive_tpu_torch.training.lbfgs import make_lbfgs_train_step
    from adaptive_tpu_torch.training.step import make_train_step

    model, cf = tiny["model"], tiny["cf"]
    calls = [lambda: make_beam_decoder(model, cf.replace(beam_size=3)),
             lambda: make_train_step(model, None, cf),
             lambda: make_lbfgs_train_step(model, None, cf),
             lambda: export_decoder(model, cf, tiny["net"], str(tmp_path / "x.pt2")),
             lambda: Config(**KNOBS, encoder_quant="int8")]
    for call in calls:
        with pytest.raises(NotImplementedError, match="granite_h_micro"):
            call()
    with pytest.raises(KeyError, match="hidden"):
        Config(**KNOBS, hybrid_lm={"hidden": 64})


def test_kernel_checks_raise():
    """ssm_step's checks, before any launch: shape, dtype, contiguity,
    device."""
    H, P, N, C, K = 2, 8, 8, 32, 4
    ok = dict(xbc=torch.zeros(3, C), dt=torch.zeros(3, H), conv_state=torch.zeros(3, K - 1, C),
              conv_w=torch.zeros(C, K), conv_b=torch.zeros(C), dt_bias=torch.zeros(H),
              A=torch.zeros(H), D=torch.zeros(H), state=torch.zeros(3, H, P, N))
    assert SS.ssm_step(**ok).shape == (3, H * P)
    bad = [dict(dt=torch.zeros(3, H + 1)), dict(conv_w=torch.zeros(C, K).bfloat16()),
           dict(A=torch.zeros(H, dtype=torch.float64)),
           dict(state=torch.zeros(3, H, N, P).transpose(2, 3)),
           dict(xbc=torch.zeros(C, 3).T), dict(xbc=torch.zeros(3, C + 1)),
           dict(D=torch.zeros(H, device="meta"))]
    for change in bad:
        with pytest.raises(ValueError):
            SS.ssm_step(**dict(ok, **change))


def test_reference_is_the_benchmarks_copy():
    assert ((ROOT / "tests" / "plain_granite_hybrid.py").read_bytes()
            == (ROOT / "benchmark" / "reference" / "granite_hybrid.py").read_bytes())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rows", [(torch.bfloat16, 1024), (torch.float32, 37)])
def test_kernel_matches_twin_at_the_cells_widths(dtype, rows):
    """Kernel 8 at granite-4.0-h-micro's widths (H 64, P 64, N 128, G 1,
    d_conv 4), xbc and dt as the row-strided slices of an in_proj output,
    against its twin on the same inputs: the state and y within a rounding
    of their dtype (fp32 sums in another order), the conv state exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    H, P, N, G, K = 64, 64, 128, 1, 4
    C = H * P + 2 * G * N
    proj = (torch.randn(rows, H * P + C + H, device=dev, generator=g)).to(dtype)
    xbc, dt = proj[:, H * P:H * P + C], proj[:, H * P + C:]
    conv = torch.randn(rows, K - 1, C, device=dev, generator=g).to(dtype)
    w = (torch.rand(C, K, device=dev, generator=g) - 0.5).to(dtype)
    b = (torch.rand(C, device=dev, generator=g) - 0.5).to(dtype)
    dt_bias = torch.rand(H, device=dev, generator=g) * 4 - 7
    A = -torch.rand(H, device=dev, generator=g) * 15 - 1
    D = torch.ones(H, device=dev)
    state = (torch.randn(rows, H, P, N, device=dev, generator=g) * 0.1).to(dtype)
    want_y, want_conv, want_state = SS.ssm_step_plain(xbc, dt, conv, w, b, dt_bias, A, D, state)
    launches = SS.ssm_step.launches
    y = SS.ssm_step(xbc, dt, conv, w, b, dt_bias, A, D, state)
    torch.cuda.synchronize()
    assert SS.ssm_step.launches == launches + 1
    tol = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}[dtype]
    torch.testing.assert_close(y.float(), want_y.float(), rtol=tol, atol=1e-5)
    torch.testing.assert_close(state.float(), want_state.float(), rtol=tol, atol=1e-5)
    assert torch.equal(conv, want_conv)
