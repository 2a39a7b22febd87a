"""The model's work from its shapes, and the roofline bounds of the
program's hand-written decode kernels, on one NVIDIA H100 SXM.

Peaks: NVIDIA's data sheet, dense rates at the 700 W limit: 989 TFLOP/s in
bf16, 3.35 TB/s of HBM. A FLOP is a multiply or an add: a product of
[m, k] by [k, n] is 2mkn. Only convolutions and matrix products count, as
torch.utils.flop_counter.FlopCounterMode counts them (the benchmark's CPU
tests hold the two against each other).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from benchmark.reference.model import BOTTLENECK_STAGES, FEATURES, slots

PEAK_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12


def trunk_convs(arch: str, crop: int) -> List[Tuple[str, float, bool]]:
    """[(conv name, forward FLOPs an image, takes the trunk's layer input)]:
    the last flag marks a layer's first conv1 and downsample, whose input
    is the previous layer's output."""
    convs = []
    h = crop // 2  # the 7x7/2 stem
    convs.append(("0", 2.0 * 3 * 64 * 49 * h * h, True))
    h //= 2  # 3x3/2 max-pool
    cin = 64
    for li, n in enumerate(BOTTLENECK_STAGES[arch]):
        width = 64 * 2 ** li
        cout = 4 * width
        for bi in range(n):
            stride = 2 if (li > 0 and bi == 0) else 1
            ho = h // stride
            p = f"{4 + li}.{bi}"
            convs.append((f"{p}.conv1", 2.0 * cin * width * h * h, bi == 0))
            convs.append((f"{p}.conv2", 2.0 * width * width * 9 * ho * ho, False))
            convs.append((f"{p}.conv3", 2.0 * width * cout * ho * ho, False))
            if bi == 0:
                convs.append((f"{p}.downsample.0", 2.0 * cin * cout * ho * ho, True))
            cin, h = cout, ho
    return convs


def trunk_flops(cfg: Dict) -> float:
    return sum(f for _, f, _ in trunk_convs(cfg["encoder_backbone"], cfg["train_crop_size"]))


def head_flops(cfg: Dict) -> Dict[str, float]:
    """Forward FLOPs an image of each affine head."""
    K, E, H = slots(cfg), cfg["word_embed_size"], cfg["lstm_hidden_size"]
    return {"affine_a": 2.0 * K * FEATURES * H, "affine_b": 2.0 * FEATURES * E,
            "affine_h0": 2.0 * FEATURES * H, "affine_c0": 2.0 * FEATURES * H}


def decoder_step_flops(cfg: Dict) -> float:
    """Forward FLOPs of one decoder step of one row: the LSTM's two
    products, the attention (the slot logits through w_h, the context),
    the sentinel's (adaptive) and the vocab head over the real vocab."""
    E, H, K = cfg["word_embed_size"], cfg["lstm_hidden_size"], slots(cfg)
    D = K
    f = 2.0 * (2 * E) * (4 * H) + 2.0 * H * (4 * H)  # x W_ih, h W_hh
    f += 2.0 * H * D + 2.0 * K * D + 2.0 * K * H  # h W_g, tanh(.) w_h, alpha V
    if cfg["atten_model_name"] == "adaptive_attention":
        f += 2.0 * (2 * E) * H + 2.0 * H * H  # the sentinel's x W_x, h W_h
        f += 2.0 * H * D + 2.0 * D  # s W_s, its logit through w_h
    return f + 2.0 * H * cfg["vocab_length"]


def slot_projection_flops(cfg: Dict) -> float:
    """V W_v, once an image."""
    K, H = slots(cfg), cfg["lstm_hidden_size"]
    return 2.0 * K * H * K


def decode_flops(cfg: Dict, images: int) -> float:
    """A greedy decode of `images`: the trunk, the heads, V W_v and
    decode_max_len decoder steps."""
    per = (trunk_flops(cfg) + sum(head_flops(cfg).values()) + slot_projection_flops(cfg)
           + cfg["decode_max_len"] * decoder_step_flops(cfg))
    return per * images


def train_forward_flops(cfg: Dict, T: int) -> float:
    """The teacher-forced forward of one image with captions of length T."""
    return (trunk_flops(cfg) + sum(head_flops(cfg).values()) + slot_projection_flops(cfg)
            + T * decoder_step_flops(cfg))


def train_step_flops(cfg: Dict, batch: int, T: int, encoder_on: bool) -> float:
    """One train step: the forward everywhere, and the backward's products
    (a weight gradient and an input gradient, each as costly as the
    forward product) for the trained parts only: the decoder and the
    affine_a/affine_b heads; with the encoder on, the trunk's children from
    opt_fine_tune_cnn_start_layer on, and the input gradients of every head
    into it. A trained layer's first convs need no input gradient."""
    dec = slot_projection_flops(cfg) + T * decoder_step_flops(cfg)
    heads = head_flops(cfg)
    bwd = 2.0 * dec + heads["affine_a"] + heads["affine_b"]
    if encoder_on:
        bwd += sum(heads.values())
        start = cfg["opt_fine_tune_cnn_start_layer"]
        for name, f, first in trunk_convs(cfg["encoder_backbone"], cfg["train_crop_size"]):
            child = 0 if name == "0" else int(name.split(".")[0])
            if child >= start:
                bwd += f if (first and child == start) else 2.0 * f
    return batch * (train_forward_flops(cfg, T) + bwd)


def bound_s(bytes_moved: float, flops: float) -> float:
    """The least time the card could take: the larger of bytes over the HBM
    rate and FLOPs over the bf16 peak."""
    return max(bytes_moved / HBM_BYTES_PER_S, flops / PEAK_BF16)


def cell_w1(cfg: Dict, rows: int) -> Tuple[float, float]:
    """(bytes, FLOPs) of one greedy launch of kernel 1, the adaptive cell:
    each input read once and each output written once at the dtypes the
    bf16 decode passes (gates x W_ih in fp32, alpha and beta out in fp32,
    the rest bf16)."""
    E2, H, K = 2 * cfg["word_embed_size"], cfg["lstm_hidden_size"], slots(cfg)
    D = K
    bf, f32 = 2, 4
    inputs = (rows * 4 * H * f32 + rows * (3 * H + E2) * bf  # gx; h, c, h_prev, x
              + rows * K * (D + H) * bf  # pv, V
              + (H * 4 * H + 4 * H + E2 * H + H * H + 2 * H * D + D) * bf)  # weights
    outputs = rows * 3 * H * bf + rows * (K + 1) * f32  # h, c, c_hat; alpha, beta
    flops = 2.0 * rows * (H * 4 * H + E2 * H + H * H + 2 * H * D + K * D + K * H)
    return inputs + outputs, flops


def head_argmax(cfg: Dict, rows: int) -> Tuple[float, float]:
    """(bytes, FLOPs) of one launch of kernel 2, the greedy head: the bf16
    head's real-vocab columns and bias, c_hat and h in, an int32 id a row
    out; the product over the real vocab."""
    H, V = cfg["lstm_hidden_size"], cfg["vocab_length"]
    return (H * V + V + 2 * rows * H) * 2 + rows * 4, 2.0 * rows * H * V
