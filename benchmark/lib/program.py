"""Set-up shared by the kinds: the port's Config from a configuration file,
the reference's view of the same sizes, and the seeded weights made on the
card, BN-calibrated, loaded into the port through its state_dict names."""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from benchmark.lib.images import seeded_images
from benchmark.reference.model import calibrate_bn, make_weights

# the Config knobs that size each variant's decoder
DECODER_SIZES = {"adaptive_attention": ("adaptive_word_embed_size", "adaptive_lstm_hidden_size"),
                 "baseline_attention": ("base_word_embed_size", "base_lstm_hidden_size")}
CALIBRATION_IMAGES = 32


def port_config(config: Dict, **overrides):
    """The port's Config from a configuration file's knobs (its other keys,
    such as source and assumed, are the file's record)."""
    from adaptive_tpu_torch.config import Config

    fields = {f.name for f in dataclasses.fields(Config)}
    knobs = {k: v for k, v in config.items() if k in fields}
    knobs.update(overrides)
    return Config(**knobs)


def reference_config(config: Dict) -> Dict:
    """The sizes and knobs the reference reads, under plain names."""
    embed, hidden = DECODER_SIZES[config["atten_model_name"]]
    return dict(config, word_embed_size=config[embed], lstm_hidden_size=config[hidden])


def seeded_weights(config: Dict, seed: int, device, mark=None) -> Dict[str, torch.Tensor]:
    """Float32 weights on device from seed, every BN's statistics
    calibrated on CALIBRATION_IMAGES seeded images (seed + 1). mark(label)
    notes the end of each phase."""
    rcfg = reference_config(config)
    w = make_weights(rcfg, seed, device)
    synchronize(device)
    if mark:
        mark("draw")
    calib = seeded_images(CALIBRATION_IMAGES, seed + 1, config["resized_image_size"], device)
    calibrate_bn(w, rcfg, calib)
    return w


def build_port(cf, weights: Dict[str, torch.Tensor], device) -> Tuple[object, torch.nn.Module]:
    """(CaptionModel, Encoder2Decoder) of the port holding `weights`
    (strict: every state_dict name must match)."""
    from adaptive_tpu_torch.models.factory import Encoder2Decoder, build_model

    model = build_model(cf, device=device)
    with torch.device("meta"):
        net = Encoder2Decoder(model.spec, model.arch)
    net = net.to_empty(device=device).eval()
    net.load_state_dict(weights, strict=True)
    return model, net


def to_host(weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: t.detach().cpu() for n, t in weights.items()}


def to_device(weights: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    return {n: t.to(device) for n, t in weights.items()}


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def free_device(device) -> None:
    import gc

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
