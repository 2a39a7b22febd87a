"""Model factory: config -> CaptionModel (encoder + decoder variant;
counterpart of adaptive_tpu/models/factory.py).

``CaptionModel`` is a static description plus the functions the train step
and the greedy and beam paths call. Its weights live in an
``Encoder2Decoder`` module whose state_dict keys are the reference
checkpoint's; ``prepare_inference`` turns them once per checkpoint into the
tree the per-batch decode functions read (BN folded, JAX layouts, compute
dtype, padded greedy head). ``forward`` is the teacher-forced train path on
the module's own weights: the trunk in the compute dtype (fp32 BN
statistics), the heads and the decoder in fp32 as JAX's type promotion has
them, fp32 master weights and gradients.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn as nn

from adaptive_tpu_torch.config import LSTM_VARIANTS, VARIANTS, unsupported
from adaptive_tpu_torch.models import decoders as D
from adaptive_tpu_torch.models import encoder as E
from adaptive_tpu_torch.models.encoder import AttentiveCNN
from adaptive_tpu_torch.models.infer import (
    cast_floating, encoder_apply_inference, prepare_encoder_inference,
)
from adaptive_tpu_torch.ops import attention as att

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device) -> torch.device:
    """torch.device for an entry point; a CUDA device must exist (there is no
    silent CPU fallback: ask for device="cpu" to run on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev


class Encoder2Decoder(nn.Module):
    """The reference's top-level module: encoder (AttentiveCNN) + decoder."""

    def __init__(self, spec: D.DecoderSpec, arch: str):
        super().__init__()
        self.encoder = AttentiveCNN(spec.embed_size, spec.hidden_size, arch)
        self.decoder = D.Decoder(spec)


class CaptionModel(NamedTuple):
    variant: str
    arch: str
    spec: D.DecoderSpec
    crop_size: int
    compute_dtype: torch.dtype
    device: torch.device
    fused: bool = True  # decode through the kernels of ops/fused_step.py
    encoder_quant: str = "none"  # none | int8 (post-training quantisation, inference only)
    # Calibrated {conv_name: scale} int8 input scales (models/infer.py::
    # calibrate_model attaches them); None -> dynamic per-batch scales.
    int8_scales: Any = None
    # Per-out-channel bias corrections from calibrate_int8_bias, added into
    # the conv biases (encoder_quant_bias_correct).
    int8_bias_corr: Any = None
    # Layers whose identity bottleneck blocks run the fused block kernel
    # (ops/fused_block.py); "auto" resolves to (), a tuple of layer names
    # overrides.
    int8_fused_layers: Any = "auto"
    # Layers whose identity-block tails fuse with the next block's conv1
    # (ops/fused_tail.py); the same "auto" contract.
    int8_fused_tails: Any = "auto"
    # Space-to-depth stem on the int8 carry (the 7x7/s2 conv1 as s2d + a
    # 4x4/s1 conv, bit-exact); "auto" = on for even crops, True/False
    # overrides.
    int8_stem_s2d: Any = "auto"
    # recompute the trunk in the backward instead of keeping its activations
    remat_encoder: bool = False
    # train-time dropout rate at the reference's Dropout sites (ops/dropout.py)
    dropout_rate: float = 0.0

    def init(self, seed: int = 0) -> Encoder2Decoder:
        """Random weights on self.device, drawn from torch.Generator(seed)
        with the JAX package's init schemes (not its random bits)."""
        with torch.device("meta"):
            net = Encoder2Decoder(self.spec, self.arch)
        net = net.to_empty(device=self.device).eval()
        gen = torch.Generator(device=self.device).manual_seed(seed)
        net.encoder.init_(gen)
        net.decoder.init_(gen)
        return net

    def encode(self, net: Encoder2Decoder, images: torch.Tensor, train: bool = False,
               drop=None, grad_from: int = 0, update_stats: bool = True, bn_group=None):
        """Preprocessed float NHWC images -> (V, v_g, h0, c0) on the net's
        own weights; train mode updates the BN statistics in place unless
        update_stats is False. grad_from, bn_group: the trunk's frozen prefix
        and BN process group (ResNet.forward). With
        remat_encoder the trunk's activations are recomputed in the backward
        (torch.utils.checkpoint); the heads, where dropout draws, stay
        outside the recomputed region, so no draw is replayed."""
        images = images.to(self.compute_dtype)
        if not (self.remat_encoder and train and torch.is_grad_enabled()):
            return E.encoder_apply(net.encoder, images, train, drop, grad_from, update_stats,
                                   bn_group)
        A_flat, a_g = _remat_features(net.encoder, images, grad_from, update_stats, bn_group)
        return E.encoder_heads(E.head_params(net.encoder, detach=False), A_flat, a_g, drop)

    def forward(self, net: Encoder2Decoder, images: torch.Tensor, captions: torch.Tensor,
                train: bool = False, gen: Optional[torch.Generator] = None,
                grad_from: int = 0, update_stats: bool = True, mesh=None):
        """Teacher-forced (scores [B,T,vocab], (alpha, beta)) (Encoder2Decoder.
        forward, baseline_attention.py:206-230, without the packing: padded
        scores and a masked loss replace pack_padded_sequence). gen draws
        the dropout masks when train and dropout_rate > 0. mesh: the images
        are this rank's block of the global batch; the masks are drawn for
        all of it (ops/dropout.py) and train-mode BN takes its moments over
        the data group."""
        from adaptive_tpu_torch.ops.dropout import make_dropout

        rows = mesh.rows if mesh is not None else None
        group = mesh.data_group if mesh is not None else None
        drop = make_dropout(gen, self.dropout_rate, rows) if train else None
        V, v_g, h0, c0 = self.encode(net, images, train, drop, grad_from, update_stats, group)
        scores, alpha, beta = D.decoder_forward(
            D.decoder_params(net.decoder, detach=False), self.spec, V, v_g,
            captions.long(), h0, c0, drop=drop)
        return scores, (alpha, beta)

    def _resolved_fusion(self):
        """(fused_layers, fused_tails, stem_s2d) with 'auto' resolved, as
        the JAX package resolves them: no fused layers or tails by default
        (both measured a net loss on the TPU, and the port's kernels are not
        faster yet either), the s2d stem on for even crops."""
        fused = () if self.int8_fused_layers == "auto" else self.int8_fused_layers
        tails = () if self.int8_fused_tails == "auto" else self.int8_fused_tails
        s2d = self.int8_stem_s2d
        if s2d == "auto":
            s2d = self.crop_size % 2 == 0  # s2d packs 2x2 pixel blocks
        elif s2d and self.crop_size % 2:
            raise ValueError(
                "int8_stem_s2d=True requires an even input size (space-to-"
                f"depth packs 2x2 pixel blocks) but crop_size={self.crop_size}"
                " is odd — use an even train_crop_size or int8_stem_s2d=False"
            )
        return fused, tails, bool(s2d)

    def prepare_inference(self, net: Encoder2Decoder, mesh=None) -> Dict:
        """{'encoder': folded encoder tree (cast to the compute dtype, or
        int8-quantised once with int8_scales), 'decoder': JAX-layout decoder
        params in the compute dtype, 'head': padded vocab head of the greedy
        and beam head kernels, None unless fused, 'cell': the adaptive cell's
        weights reordered for its tensor-core instance (fs.CellTiles), None
        unless fused, adaptive and that instance runs}. On a mesh
        (decoding/spmd.py) this rank's slice of it: the embedding's rows and
        the head's columns (and the shard's tiles) of its model rank, and
        'tp', the decode steps' (model group, head_tp)."""
        _, _, s2d = self._resolved_fusion()
        with torch.no_grad():
            enc = prepare_encoder_inference(
                net.encoder, self.compute_dtype, self.encoder_quant, scales=self.int8_scales,
                stem_s2d=s2d, bias_corr=self.int8_bias_corr)
            dec = cast_floating(D.decoder_params(net.decoder), self.compute_dtype)
            head = self.prepare_greedy_head(dec)
            cell = (D.prepare_cell_tiles(dec)
                    if self.fused and self.variant == "adaptive_attention" else None)
            prepared = {"encoder": enc, "decoder": dec, "head": head, "cell": cell}
            if mesh is not None:
                from adaptive_tpu_torch.decoding.spmd import prepared_specs

                prepared = prepared_specs(prepared, mesh)
        return prepared

    def encode_inference(self, prepared: Dict, images: torch.Tensor):
        """Preprocessed float NHWC images -> (V, v_g, h0, c0)."""
        fused, tails, s2d = self._resolved_fusion()
        return encoder_apply_inference(
            None, images, self.arch, self.compute_dtype, self.encoder_quant,
            scales=self.int8_scales, fused_layers=fused, fused_tails=tails, stem_s2d=s2d,
            prepared=prepared["encoder"], bias_corr=self.int8_bias_corr)

    def prepare_greedy_head(self, dec_params: Dict):
        if not self.fused:
            return None
        return D.prepare_greedy_head(dec_params, self.spec)

    def precompute_slots(self, dec_params: Dict, V: torch.Tensor) -> torch.Tensor:
        return att.precompute_slots(dec_params["adaptive"]["atten"], V)

    def init_decode_state(self, h0, c0) -> D.DecodeState:
        return D.DecodeState(h=h0, c=c0, h_prev=torch.zeros_like(h0))

    def decode_step(self, dec_params, token, v_g, dstate, V,
                    sentinel_uses_prev_hidden=False, pv=None):
        return D.decode_step(dec_params, self.spec, token, v_g, dstate, V,
                             sentinel_uses_prev_hidden, pv=pv, fused=self.fused)

    def greedy_decode_step(self, dec_params, token, v_g, dstate, V,
                           sentinel_uses_prev_hidden=False, pv=None, head=None, cell_t=None,
                           tp_group=None, head_tp=False):
        """tp_group, head_tp: the model group of a mesh and whether the head
        is column-sharded over it (prepare_inference's 'tp')."""
        return D.greedy_decode_step(dec_params, self.spec, token, v_g, dstate, V,
                                    sentinel_uses_prev_hidden, pv=pv, head=head,
                                    fused=self.fused, cell_t=cell_t, tp_group=tp_group,
                                    head_tp=head_tp)

    def beam_decode_step(self, dec_params, token, v_g, dstate, V, k,
                         sentinel_uses_prev_hidden=False, pv=None, head=None, beam_w=1,
                         cell_t=None, tp_group=None, head_tp=False):
        """Each row's top-k log-probs and token ids; the padded head of
        prepare_greedy_head serves the fused top-k head too. beam_w > 1
        takes V/pv untiled (beam-major); tp_group, head_tp as
        greedy_decode_step's."""
        return D.beam_decode_step(dec_params, self.spec, token, v_g, dstate, V, k,
                                  sentinel_uses_prev_hidden, pv=pv, head=head,
                                  fused=self.fused, beam_w=beam_w, cell_t=cell_t,
                                  tp_group=tp_group, head_tp=head_tp)


def require_lstm(model, what: str) -> None:
    """Raise config.unsupported (NotImplementedError naming the variant)
    where model is not a CaptionModel: the hybrid LM decoder
    (models/hybrid_lm.py) runs greedy decoding only."""
    if not isinstance(model, CaptionModel):
        raise unsupported(model.variant, what)


def build_model(cf, device="cuda") -> CaptionModel:
    """The CaptionModel of cf's LSTM variant, or the HybridModel of a hybrid
    LM variant (models/hybrid_lm.py), on device."""
    if cf.atten_model_name not in VARIANTS:
        raise ValueError(f"unknown atten_model_name {cf.atten_model_name!r}")
    if cf.atten_model_name not in LSTM_VARIANTS:
        from adaptive_tpu_torch.models.hybrid_lm import build_hybrid

        return build_hybrid(cf, resolve_device(device), DTYPES[cf.compute_dtype])
    if cf.atten_model_name == "rnn_attention" and cf.rnn_attention_numlayers != 1:
        # only the 1-layer attention LSTM of rnn_attention.py:25 is
        # implemented; the other variants never read the knob
        raise NotImplementedError(
            f"rnn_attention_numlayers={cf.rnn_attention_numlayers} — only 1 "
            "layer is implemented"
        )
    dev = resolve_device(device)
    num_slots = (cf.train_crop_size // 32) ** 2  # 49 at 224 (7x7 map)
    m = max(1, cf.vocab_pad_multiple)
    padded_vocab = ((cf.vocab_length + m - 1) // m) * m
    spec = D.DecoderSpec(
        variant=cf.atten_model_name,
        embed_size=cf.word_embed_size,
        hidden_size=cf.lstm_hidden_size,
        vocab_size=cf.vocab_length,
        num_slots=num_slots,
        atten_dim=num_slots,
        rnn_bidirectional=cf.rnn_attention_bidirectional,
        rnn_num_layers=cf.rnn_attention_numlayers,
        padded_vocab=padded_vocab if padded_vocab != cf.vocab_length else 0,
    )
    return CaptionModel(
        variant=cf.atten_model_name,
        arch=cf.encoder_backbone,
        spec=spec,
        crop_size=cf.train_crop_size,
        compute_dtype=DTYPES[cf.compute_dtype],
        device=dev,
        fused=cf.use_pallas != "never",
        encoder_quant=cf.encoder_quant,
        remat_encoder=cf.remat_encoder,
        dropout_rate=float(cf.train_dropout_rate),
    )


def _remat_features(enc: AttentiveCNN, images: torch.Tensor, grad_from: int,
                    update_stats: bool = True, bn_group=None):
    """encoder_features in train mode under torch.utils.checkpoint. The
    backward's recompute would update the BN running statistics a second
    time: it restores them as the forward left them."""
    from torch.utils.checkpoint import checkpoint

    bufs = enc.resnet_conv.bn_buffers()
    ran = []

    def trunk(x):
        if not ran:
            ran.append(True)
            return E.encoder_features(enc, x, True, grad_from, update_stats, bn_group)
        with torch.no_grad():
            saved = [b.clone() for b in bufs]
        try:
            return E.encoder_features(enc, x, True, grad_from, update_stats, bn_group)
        finally:  # also when the recompute stops early
            with torch.no_grad():
                for b, v in zip(bufs, saved):
                    b.copy_(v)

    return checkpoint(trunk, images, use_reentrant=False)


def get_model(cf, seed: Optional[int] = None, device="cuda"):
    """(model, net, start_epoch): the net drawn from seed (default
    cf.train_random_seed), a pretrained trunk (encoder_pretrained_npz)
    installed, then a training checkpoint restored over them, the start
    epoch parsed from its name (model_factory.py:14-21). The order matters:
    the pretrained weights are the base, as the reference loads them at
    construction; a resume never resets a fine-tuned trunk to them."""
    model = build_model(cf, device=device)
    net = model.init(cf.train_random_seed if seed is None else seed)
    if cf.encoder_pretrained_npz:
        from adaptive_tpu_torch.models.torch_import import load_pretrained_resnet

        load_pretrained_resnet(cf.encoder_pretrained_npz, net)
    start_epoch = 1
    if cf.train_pretrained and cf.train_pretrained_model:
        from adaptive_tpu_torch.training import checkpoint as ckpt

        ckpt.restore_model(cf.train_pretrained_model, net, model.arch)
        start_epoch = ckpt.epoch_from_filename(cf.train_pretrained_model) + 1
    return model, net, start_epoch


def load_jax_weights(model: CaptionModel, params, state) -> Encoder2Decoder:
    """An Encoder2Decoder on model.device holding a JAX parameter tree (numpy
    leaves), through the weight bridge in models/jax_params.py."""
    from adaptive_tpu_torch.models.jax_params import from_jax

    with torch.device("meta"):
        net = Encoder2Decoder(model.spec, model.arch)
    net = net.to_empty(device=model.device).eval()
    net.load_state_dict(from_jax(params, state, model.arch))
    return net
