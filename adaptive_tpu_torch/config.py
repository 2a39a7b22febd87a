"""Configuration for the PyTorch port: the knobs the greedy and beam
captioning paths and the eval driver read, with the same names and
defaults as the JAX package's ``Config`` (adaptive_tpu/config/config.py).

The port keeps its own copy instead of importing the JAX package's module,
so the two packages can be installed and run apart. Only the fields that the
ported slice reads are here; later slices add theirs under the same names.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

VARIANTS = ("baseline_attention", "adaptive_attention", "rnn_attention")


@dataclass
class Config:
    # paths the eval driver reads (cfg_wzn.py:1-12)
    vocab_path: str = "data/vocab.json"
    resized_image_dir: str = "data/MSCOCO/resized"
    val_anno_path: str = "data/annotations/karpathy_split_val.json"
    test_anno_path: str = "data/annotations/karpathy_split_test.json"
    train_eval_anno_path: str = "data/annotations/karpathy_split_train_eval.json"
    train_random_seed: int = 123  # cfg_wzn.py:21; seeds model.init in valid/test mode
    # eval knobs (cfg_wzn.py:78-86)
    test_pretrained_model: str = ""  # a checkpoint dir, its model.npz, or "auto"
    valid_pretrained_model: str = ""
    eval_batch_size: int = 400
    dataloader_num_workers: int = 8  # host-side prefetch threads
    # valid/test "auto" also searches here after exp_dir/trained_models
    train_auto_resume_dir: str = ""
    exp_dir: str = ""  # results files land here ("" = the working directory)
    atten_model_name: str = "adaptive_attention"  # baseline_attention|adaptive_attention|rnn_attention
    train_crop_size: int = 224
    decode_max_len: int = 30
    beam_size: int = 1  # 1 = greedy; > 1 is make_beam_decoder's default width
    vocab_length: int = 10123
    # Pad the embedding/head vocab dim to a multiple; padded logits are masked
    # so argmax equals the unpadded model's. 1 = no padding.
    vocab_pad_multiple: int = 1
    adaptive_word_embed_size: int = 256
    adaptive_lstm_hidden_size: int = 512
    encoder_backbone: str = "resnet152"  # resnet18|34|50|101|152
    compute_dtype: str = "float32"  # float32|bfloat16
    # auto|always: the decode step runs the fused kernels (ops/fused_step.py);
    # never: the plain op-by-op path (ops/lstm.py + ops/attention.py).
    use_pallas: str = "auto"
    # Inference-only encoder quantization: 'int8' runs the BN-folded convs as
    # int8 products (int32 accumulation) on the s8 residual carry, with
    # calibrated static activation scales (models/infer.py::calibrate_model)
    # or, uncalibrated, dynamic per-tensor ones.
    encoder_quant: str = "none"  # none|int8
    # int8 activation-scale granularity: 'channel' calibrates one scale per
    # input channel and folds it into the conv kernels (models/infer.py::
    # _quant_conv_weight); 'tensor' is one scale per conv input, which the
    # fused block and tail kernels (ops/fused_block.py, ops/fused_tail.py)
    # require.
    encoder_quant_granularity: str = "channel"  # channel|tensor
    # Sequential per-channel bias correction at calibration time
    # (models/infer.py::calibrate_int8_bias); zero runtime cost.
    encoder_quant_bias_correct: bool = False
    # The reference sampler feeds the sentinel h_{t-1}=0 at every step; True
    # uses the true previous hidden instead.
    sampler_sentinel_uses_prev_hidden: bool = False
    decode_eos_token: int = 2
    decode_start_token: int = 1
    # Stop once every row (greedy) or every beam (beam search) has emitted
    # <end>; ids equal the fixed loop's.
    decode_early_exit: bool = False
    # Beam decode slot layout on the fused path: True passes V/pv untiled
    # and the cell kernel maps row r to image r // W (each image's slots are
    # read once a step); False repeats V/pv per beam row. Same outputs.
    decode_beam_major: bool = True

    def __post_init__(self):
        if self.encoder_quant not in ("none", "int8"):
            raise ValueError(f"encoder_quant={self.encoder_quant!r} — must be none|int8")
        if self.encoder_quant_granularity not in ("channel", "tensor"):
            raise ValueError(
                f"encoder_quant_granularity={self.encoder_quant_granularity!r} — "
                "must be channel|tensor"
            )

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    @property
    def word_embed_size(self) -> int:
        if self.atten_model_name != "adaptive_attention":
            raise NotImplementedError(
                f"{self.atten_model_name} is not ported yet (ROADMAP.md, queue 1)"
            )
        return self.adaptive_word_embed_size

    @property
    def lstm_hidden_size(self) -> int:
        if self.atten_model_name != "adaptive_attention":
            raise NotImplementedError(
                f"{self.atten_model_name} is not ported yet (ROADMAP.md, queue 1)"
            )
        return self.adaptive_lstm_hidden_size
