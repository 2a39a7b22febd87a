"""Serialized decoder export through torch.export (counterpart of
adaptive_tpu/export.py, which writes StableHLO through jax.export).

The whole inference pipeline (eval preprocessing, the BN-folded, optionally
int8, encoder, and the greedy or beam decode loop) exports as one
``torch.export`` program at a fixed batch, with the prepared weights inside
the artifact:

    from adaptive_tpu_torch.export import export_decoder, load_decoder
    path = export_decoder(model, cf, net, "decoder.pt2", batch_size=8)
    decode = load_decoder(path)         # images_u8 [B,S,S,3] -> dict of tensors
    out = decode(images)                # {'ids', 'attention', 'beta'}

The kernels enter the program as the operators of the ``adaptive_tpu_torch``
namespace (ops/fused_step.py::define_op), so the artifact needs the port's
operator library to run: ``load_decoder`` imports it. The program runs on
the device it was exported on, and each call launches the same kernels as
the in-process decoder. The decode loop is unrolled at export time; with
``decode_early_exit`` it runs every step and zeroes attention and beta after
the step at which all rows have finished (the decoders do so when traced),
which gives the early-exit decoder's outputs.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch

from adaptive_tpu_torch.models.factory import require_lstm


class _DecodeProgram(torch.nn.Module):
    """images_u8 -> {'ids', 'attention', 'beta'} over the prepared weights,
    which the export lifts into the artifact as constants."""

    def __init__(self, decode_prepared, prepared):
        super().__init__()
        self._decode = decode_prepared
        self._prepared = prepared

    def forward(self, images_u8):
        out = self._decode(self._prepared, images_u8)
        return {k: getattr(out, k) for k in ("ids", "attention", "beta")}


def export_decoder(model, cf, net, path: str, batch_size: Optional[int] = None) -> str:
    """Export the decode pipeline of net's weights (prepared once, inside
    the artifact) at a fixed batch to path (torch.export.save); returns
    path. batch_size fixes the batch (static shapes, CaptionService's fixed
    micro-batch), cf.eval_batch_size where None. The program is traced on
    model.device: a CUDA model exports a program that launches the CUDA
    kernels, a CPU one a program of the plain twins."""
    from adaptive_tpu_torch.decoding import make_beam_decoder, make_greedy_decoder

    require_lstm(model, "export")
    decode = (make_beam_decoder(model, cf) if cf.beam_size > 1
              else make_greedy_decoder(model, cf))
    B = batch_size or cf.eval_batch_size
    S = cf.resized_image_size
    program = _DecodeProgram(decode.decode_prepared, model.prepare_inference(net))
    example = torch.zeros((B, S, S, 3), dtype=torch.uint8, device=model.device)
    with torch.no_grad():
        exported = torch.export.export(program, (example,), strict=False)
    with warnings.catch_warnings():
        # channels-last conv weights fill their storage, but not in the
        # order the archive's check for a whole tensor expects; it then
        # stores the storage's whole span, which is the same bytes
        warnings.filterwarnings("ignore", "No complete tensor found")
        torch.export.save(exported, path)
    return path


def load_decoder(path: str):
    """Load an exported decoder; returns images_u8 (numpy or tensor) ->
    dict of tensors on the program's device. A batch or image size other
    than the exported one raises."""
    import adaptive_tpu_torch.ops.conv_epilogue  # noqa: F401  the operators the
    import adaptive_tpu_torch.ops.fused_block  # noqa: F401  program calls
    import adaptive_tpu_torch.ops.fused_step  # noqa: F401
    import adaptive_tpu_torch.ops.fused_tail  # noqa: F401

    exported = torch.export.load(path)
    device = next(iter(exported.constants.values())).device  # where the weights are
    program = exported.module()

    def decode(images_u8):
        with torch.no_grad():
            return program(torch.as_tensor(images_u8, device=device))

    decode.program = program
    return decode
