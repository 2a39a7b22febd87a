"""Configuration for the PyTorch port: the knobs the greedy and beam
captioning paths, the eval driver and training read, with the same names
and defaults as the JAX package's ``Config`` (adaptive_tpu/config/config.py).

The port keeps its own copy instead of importing the JAX package's module,
so the two packages can be installed and run apart. Only the fields that the
ported slice reads are here; later slices add theirs under the same names.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

VARIANTS = ("baseline_attention", "adaptive_attention", "rnn_attention")
OPTIMIZERS = ("adam", "sgd", "lbfgs")
LBFGS_NOT_PORTED = ("the lbfgs optimizer is not ported yet: ROADMAP.md, queue 1 "
                    "(training/lbfgs.py)")


@dataclass
class Config:
    # paths the eval driver reads (cfg_wzn.py:1-12)
    vocab_path: str = "data/vocab.json"
    resized_image_dir: str = "data/MSCOCO/resized"
    val_anno_path: str = "data/annotations/karpathy_split_val.json"
    test_anno_path: str = "data/annotations/karpathy_split_test.json"
    train_eval_anno_path: str = "data/annotations/karpathy_split_train_eval.json"
    train_anno_path: str = "data/annotations/karpathy_split_train.json"
    # train knobs (cfg_wzn.py:19-34)
    train_log_step: int = 10
    train_random_seed: int = 123  # cfg_wzn.py:21; seeds model.init and the train draws
    train_pretrained: bool = False
    train_pretrained_model: str = ""  # a checkpoint dir to start from
    train_num_epochs: int = 30
    train_batch_size: int = 24
    train_early_stop: bool = True
    train_early_stop_patience: int = 6
    train_evalOrnot: bool = False  # per-epoch CIDEr on train_eval and val
    train_tb_interval_batches: int = 1180  # weight histograms + batch loss cadence
    train_tb_lstm_clip_grad: bool = True  # also log the LSTM grad norm then
    train_lstm_maxnormal: float = 5.0  # clip_grad_norm_ over the decoder LSTM
    # inverted dropout at the reference's (rate-0) Dropout sites; 0 = off
    train_dropout_rate: float = 0.0
    # optimization (cfg_wzn.py:37-75): ResNet children [start_layer:] are
    # fine-tuned from epoch start_epoch + 1
    opt_fine_tune_cnn_start_layer: int = 5
    opt_fine_tune_cnn_start_epoch: int = 20
    opt_lrdecay_patience: int = 3
    opt_lrdecay_factor: float = 0.5
    opt_rnn_optimization: str = "adam"  # adam|sgd (lbfgs: not ported)
    opt_rnn_adam_alpha: float = 0.8  # beta1
    opt_rnn_adam_beta: float = 0.999  # beta2
    opt_rnn_adam_learning_rate: float = 1e-3
    opt_rnn_adam_weight_decay: float = 0.0
    opt_rnn_sgd_learning_rate: float = 5e-2
    opt_rnn_sgd_momentum: float = 0.3
    opt_rnn_sgd_weight_decay: float = 0.0
    opt_rnn_lbfgs_lr: float = 0.5
    opt_rnn_lbfgs_max_iter: int = 20
    opt_rnn_lbfgs_history: int = 50
    opt_cnn_optimization: str = "adam"
    opt_cnn_adam_alpha: float = 0.8
    opt_cnn_adam_beta: float = 0.999
    opt_cnn_adam_learning_rate: float = 1e-5
    opt_cnn_adam_weight_decay: float = 0.0
    opt_cnn_sgd_learning_rate: float = 4e-5
    opt_cnn_sgd_momentum: float = 0.99
    opt_cnn_sgd_weight_decay: float = 0.0
    opt_cnn_lbfgs_lr: float = 0.01
    opt_cnn_lbfgs_max_iter: int = 20
    opt_cnn_lbfgs_history: int = 50
    # recompute the encoder's trunk in the backward instead of keeping its
    # activations (torch.utils.checkpoint)
    remat_encoder: bool = False
    # a mid-epoch 'cider-0.0000_model-E_step-K' checkpoint every N steps
    # (0 = per-epoch only); auto-resume restarts at step K of epoch E
    train_checkpoint_every_steps: int = 0
    # microbatches a batch's gradient is summed over (the exact full-batch
    # gradient); 1 = off
    train_grad_accum_steps: int = 1
    # ImageNet weights converted from torch (not ported: ROADMAP.md, queue 1)
    encoder_pretrained_npz: str = ""
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
        for knob in ("opt_rnn_optimization", "opt_cnn_optimization"):
            v = getattr(self, knob)
            if v not in OPTIMIZERS:
                raise ValueError(f"{knob}={v!r} — must be adam|sgd|lbfgs")
        if not 0.0 <= self.train_dropout_rate < 1.0:
            raise ValueError(
                f"train_dropout_rate={self.train_dropout_rate} — must be in [0, 1) "
                "(0 disables dropout, matching the reference's hardcoded Dropout(0))"
            )
        if self.train_grad_accum_steps < 1:
            raise ValueError(
                f"train_grad_accum_steps={self.train_grad_accum_steps} — must be >= 1")
        if self.train_batch_size % self.train_grad_accum_steps != 0:
            raise ValueError(
                f"train_grad_accum_steps={self.train_grad_accum_steps} must divide "
                f"train_batch_size={self.train_batch_size}"
            )
        lbfgs = "lbfgs" in (self.opt_rnn_optimization, self.opt_cnn_optimization)
        if self.train_grad_accum_steps > 1 and lbfgs:
            raise NotImplementedError(
                "train_grad_accum_steps > 1 is not supported with lbfgs optimizer groups")
        if lbfgs:
            raise NotImplementedError(LBFGS_NOT_PORTED)
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
