"""Configuration for the PyTorch port: every knob of the JAX package's
``Config`` (adaptive_tpu/config/config.py), with the same names, defaults and
field order, and its loader ``load_config``.

The port keeps its own copy instead of importing the JAX package's module,
so the two packages can be installed and run apart. A Python file, a JSON
file, a dict or a Config is the source, as in the JAX package: the
reference's "config file is the experiment record" workflow (cfg_wzn.py,
configuration.py:25-40).

Checks run when a Config is made (``_validate``, the JAX package's, which it
runs in ``load_config`` only). Every knob loads as in the JAX package; the
LSTM decoders' sizes pick the ``atten_model_name``'s pair
(``word_embed_size``, ``lstm_hidden_size``). The port adds a variant the JAX
package lacks, ``granite_h_micro``: a hybrid Mamba-2/attention language
model as the caption decoder (models/hybrid_lm.py), sized by its own knob
``hybrid_lm``. The mesh knobs (``mesh_shape``, ``mesh_axes``), ZeRO-1
(``opt_state_sharding``) and ``distributed_init`` are read by the
``parallel`` package. ``param_dtype`` and ``train_tb_gradOrnot`` are read
nowhere in the JAX package and nowhere here; ``decode_scan_prefix`` changes
no id and the port's decode loops are Python loops either way (ROADMAP.md
§3).
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

LSTM_VARIANTS = ("baseline_attention", "adaptive_attention", "rnn_attention")
# and the decoders that are a hybrid language model over the trunk map's
# image tokens (models/hybrid_lm.py)
VARIANTS = LSTM_VARIANTS + ("granite_h_micro",)
OPTIMIZERS = ("adam", "sgd", "lbfgs")


@dataclass
class Config:
    # paths (cfg_wzn.py:1-12)
    experiment_path: str = "Experiments"
    vocab_path: str = "data/vocab.json"
    image_dir: str = "data/MSCOCO"
    resized_image_dir: str = "data/MSCOCO/resized"
    captions_val_origin: str = "data/MSCOCO/annotations/captions_val2014.json"
    captions_train_origin: str = "data/MSCOCO/annotations/captions_train2014.json"
    splited_anno_path_prefix: str = "data/annotations/karpathy_split_"
    train_anno_path: str = "data/annotations/karpathy_split_train.json"
    val_anno_path: str = "data/annotations/karpathy_split_val.json"
    test_anno_path: str = "data/annotations/karpathy_split_test.json"
    train_eval_anno_path: str = "data/annotations/karpathy_split_train_eval.json"

    # baseline_attention|adaptive_attention|rnn_attention|granite_h_micro
    atten_model_name: str = "adaptive_attention"

    # stage flags (main.py), the reference's names and spelling
    trainOrnot: bool = False
    validOrnot: bool = False
    testOrnot: bool = False
    resizeOrnot: bool = False
    vacab_build_Ornot: bool = False
    KarpathySplitOrnot: bool = False

    # train knobs (cfg_wzn.py:19-34)
    train_crop_size: int = 224
    train_log_step: int = 10
    train_random_seed: int = 123  # seeds model.init, the split and the train draws
    train_pretrained: bool = False
    train_pretrained_model: str = ""  # a checkpoint dir to start from
    train_num_epochs: int = 30
    train_batch_size: int = 24
    train_early_stop: bool = True
    train_early_stop_patience: int = 6
    train_evalOrnot: bool = False  # per-epoch CIDEr on train_eval and val
    train_tb_interval_batches: int = 1180  # weight histograms + batch loss cadence
    train_tb_gradOrnot: bool = True  # read nowhere (as in the JAX package)
    train_tb_lstm_clip_grad: bool = True  # also log the LSTM grad norm then
    train_lstm_maxnormal: float = 5.0  # clip_grad_norm_ over the decoder LSTM
    # inverted dropout at the reference's (rate-0) Dropout sites; 0 = off.
    # The L-BFGS step draws one set of masks a batch (training/lbfgs.py).
    train_dropout_rate: float = 0.0

    # optimization (cfg_wzn.py:37-75): ResNet children [start_layer:] are
    # fine-tuned from epoch start_epoch + 1
    opt_fine_tune_cnn_start_layer: int = 5
    opt_fine_tune_cnn_start_epoch: int = 20
    opt_lrdecay_patience: int = 3
    opt_lrdecay_factor: float = 0.5
    opt_rnn_optimization: str = "adam"  # adam|sgd|lbfgs
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

    # eval knobs (cfg_wzn.py:78-86)
    test_pretrained_model: str = ""  # a checkpoint dir, its model.npz, or "auto"
    valid_pretrained_model: str = ""
    eval_batch_size: int = 400
    dataloader_num_workers: int = 8  # host-side prefetch threads
    decode_max_len: int = 30
    beam_size: int = 1  # 1 = greedy; > 1 is make_beam_decoder's default width

    # preprocessing stages (cfg_wzn.py:90-94)
    resized_image_size: int = 256
    vocab_threshold: int = 5

    # Karpathy split sizes (cfg_wzn.py:96-106)
    num_val: int = 5000
    num_test: int = 5000
    num_train_eval: int = 5000
    num_train_overfit: int = 20
    num_train_hyperparameter: int = 5000
    num_train_eval_hyperparameter: int = 1000
    num_val_hyperparameter: int = 1000

    # per-model sizes (cfg_wzn.py:108-122)
    vocab_length: int = 10123
    # Pad the embedding/head vocab dim to a multiple; padded logits are masked
    # so argmax equals the unpadded model's. 1 = no padding.
    vocab_pad_multiple: int = 1
    # word_embed_size and lstm_hidden_size pick the atten_model_name's pair
    base_word_embed_size: int = 256
    base_lstm_hidden_size: int = 512
    adaptive_word_embed_size: int = 256
    adaptive_lstm_hidden_size: int = 512
    rnn_attention_bidirectional: bool = True
    rnn_attention_embed_size: int = 256
    rnn_attention_numlayers: int = 1  # only 1 is implemented (_validate)
    rnn_attention_hiddensize: int = 512
    # granite_h_micro's language model: Hugging Face config.json keys of
    # granite-4.0-h-micro (models/hybrid_lm.py::PUBLISHED) that replace the
    # published values; None runs the published model. Its vocabulary is
    # vocab_length. Read by no other variant.
    hybrid_lm: Optional[Dict[str, Any]] = None

    encoder_backbone: str = "resnet152"  # resnet18|34|50|101|152
    # a trunk converted from torchvision weights (the JAX package's
    # save_resnet_npz), installed before a training checkpoint restores over
    # it (models/torch_import.py)
    encoder_pretrained_npz: str = ""
    compute_dtype: str = "float32"  # float32|bfloat16
    param_dtype: str = "float32"  # read nowhere (as in the JAX package)
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
    # Beam decode slot layout on the fused path: True passes V/pv untiled
    # and the cell kernel maps row r to image r // W (each image's slots are
    # read once a step); False repeats V/pv per beam row. Same outputs.
    decode_beam_major: bool = True
    # Stop once every row (greedy) or every beam (beam search) has emitted
    # <end>; ids equal the fixed loop's.
    decode_early_exit: bool = False
    # accepted with no effect: the JAX package's fixed-scan prefix of the
    # early-exit loop changes no id (ROADMAP.md §3)
    decode_scan_prefix: int = 0
    # the mesh over the ranks of the default process group: axis 0 splits the
    # batch, axis 1 the decode's vocab head; -1 sizes one axis to the world
    # (parallel/mesh.py)
    mesh_axes: Tuple[str, ...] = ("data", "model")
    mesh_shape: Tuple[int, ...] = (-1, 1)
    # recompute the encoder's trunk in the backward instead of keeping its
    # activations (torch.utils.checkpoint)
    remat_encoder: bool = False
    # valid/test "auto" also searches here after exp_dir/trained_models; a
    # checkpoint here is resumed (training/train_loop.py)
    train_auto_resume_dir: str = ""
    # a mid-epoch 'cider-0.0000_model-E_step-K' checkpoint every N steps
    # (0 = per-epoch only); auto-resume restarts at step K of epoch E
    train_checkpoint_every_steps: int = 0
    # microbatches a batch's gradient is summed over (the exact full-batch
    # gradient); 1 = off
    train_grad_accum_steps: int = 1
    # "data": ZeRO-1, Adam/SGD moments sharded over the data axis
    # (training/optim.py::shard_opt_state)
    opt_state_sharding: str = "replicated"
    # start torch.distributed at the CLI's start (main.py); torchrun's
    # WORLD_SIZE > 1 starts it too
    distributed_init: bool = False

    # filled by Experiment.setup (experiment.py)
    exp_dir: str = ""  # results files land here ("" = the working directory)
    model_description: str = ""
    log_file: str = ""

    def __post_init__(self):
        _validate(self)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, default=str)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    @property
    def word_embed_size(self) -> int:
        return {
            "baseline_attention": self.base_word_embed_size,
            "adaptive_attention": self.adaptive_word_embed_size,
            "rnn_attention": self.rnn_attention_embed_size,
        }[self.atten_model_name]

    @property
    def lstm_hidden_size(self) -> int:
        return {
            "baseline_attention": self.base_lstm_hidden_size,
            "adaptive_attention": self.adaptive_lstm_hidden_size,
            "rnn_attention": self.rnn_attention_hiddensize,
        }[self.atten_model_name]


def unsupported(variant: str, what: str):
    """The NotImplementedError of a path a hybrid LM variant does not run."""
    return NotImplementedError(
        f"{what} is not implemented for atten_model_name={variant!r}: the hybrid LM decoder "
        "runs greedy decoding only (decoding/greedy.py)")


_CONFIG_FIELDS = {f.name for f in dataclasses.fields(Config)}


def load_config(source: Any = None, **overrides) -> Config:
    """Build a Config from a Python file path, a JSON file path, a dict, a
    Config, or keyword overrides (the JAX package's load_config).

    The module-level variables of a Python file whose names are Config
    fields become field values; other names are ignored (the reference
    tolerated extras), but a near-miss of a field's name is warned about.
    An unknown override raises KeyError."""
    values: Dict[str, Any] = {}
    if isinstance(source, str) and source.endswith(".py"):
        ns: Dict[str, Any] = {}
        with open(source) as f:
            exec(compile(f.read(), source, "exec"), ns)  # noqa: S102 - by design
        values = {k: v for k, v in ns.items() if k in _CONFIG_FIELDS}
        _warn_near_misses(ns, source)
    elif isinstance(source, str) and source.endswith(".json"):
        with open(source) as f:
            raw = json.load(f)
        values = {k: v for k, v in raw.items() if k in _CONFIG_FIELDS}
    elif isinstance(source, dict):
        values = {k: v for k, v in source.items() if k in _CONFIG_FIELDS}
    elif isinstance(source, Config):
        values = source.to_dict()
    elif source is not None:
        raise TypeError(f"Unsupported config source: {type(source)}")

    values.update({k: v for k, v in overrides.items() if k in _CONFIG_FIELDS})
    unknown = set(overrides) - _CONFIG_FIELDS
    if unknown:
        raise KeyError(f"Unknown config fields: {sorted(unknown)}")
    # tuple-typed fields may arrive as lists from JSON
    for k in ("mesh_axes", "mesh_shape"):
        if k in values and isinstance(values[k], list):
            values[k] = tuple(values[k])
    return Config(**values)


def _warn_near_misses(ns: Dict[str, Any], source: str) -> None:
    """Print a warning for each file variable that looks like a typo of a
    field (num_epochs for train_num_epochs): a long shared suffix first,
    then difflib's closest match."""
    import difflib
    import types

    def suffix(a, b):
        return len(os.path.commonprefix([a[::-1], b[::-1]]))

    for k, v in ns.items():
        if (k.startswith("_") or k in _CONFIG_FIELDS
                or callable(v) or isinstance(v, types.ModuleType)):
            continue
        by_suffix = max(sorted(_CONFIG_FIELDS), key=lambda f: suffix(k, f))
        if suffix(k, by_suffix) >= 8:
            hint = [by_suffix]
        else:
            hint = difflib.get_close_matches(k, _CONFIG_FIELDS, n=1, cutoff=0.7)
        if hint:
            print(f"[config] WARNING: '{k}' in {source} is not a Config "
                  f"field and was IGNORED — did you mean '{hint[0]}'?")


def _validate(cf: Config) -> None:
    """Fail fast on invalid knobs, before any data loading starts: the JAX
    package's checks in its order, with its messages."""
    if cf.atten_model_name not in VARIANTS:
        raise ValueError(
            f"atten_model_name={cf.atten_model_name!r} — must be one of {VARIANTS}"
        )
    for knob in ("opt_rnn_optimization", "opt_cnn_optimization"):
        v = getattr(cf, knob)
        if v not in OPTIMIZERS:
            raise ValueError(f"{knob}={v!r} — must be adam|sgd|lbfgs")
    if cf.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype={cf.compute_dtype!r}")
    if cf.use_pallas not in ("auto", "always", "never"):
        raise ValueError(f"use_pallas={cf.use_pallas!r}")
    if cf.encoder_quant not in ("none", "int8"):
        raise ValueError(f"encoder_quant={cf.encoder_quant!r} — must be none|int8")
    if cf.encoder_quant_granularity not in ("channel", "tensor"):
        raise ValueError(
            f"encoder_quant_granularity={cf.encoder_quant_granularity!r} — "
            "must be channel|tensor"
        )
    if cf.opt_state_sharding not in ("replicated", "data"):
        raise ValueError(
            f"opt_state_sharding={cf.opt_state_sharding!r} — must be replicated|data"
        )
    if not 0.0 <= cf.train_dropout_rate < 1.0:
        raise ValueError(
            f"train_dropout_rate={cf.train_dropout_rate} — must be in [0, 1) "
            "(0 disables dropout, matching the reference's hardcoded Dropout(0))"
        )
    if cf.train_grad_accum_steps < 1:
        raise ValueError(
            f"train_grad_accum_steps={cf.train_grad_accum_steps} — must be >= 1"
        )
    if cf.train_batch_size % max(1, cf.train_grad_accum_steps) != 0:
        raise ValueError(
            f"train_grad_accum_steps={cf.train_grad_accum_steps} must divide "
            f"train_batch_size={cf.train_batch_size}"
        )
    if cf.train_grad_accum_steps > 1 and "lbfgs" in (
        cf.opt_rnn_optimization, cf.opt_cnn_optimization
    ):
        # the L-BFGS closure step (training/lbfgs.py) is monolithic; accepting
        # the knob there would silently skip the requested microbatching
        raise NotImplementedError(
            "train_grad_accum_steps > 1 is not supported with lbfgs optimizer groups"
        )
    if cf.atten_model_name == "rnn_attention" and cf.rnn_attention_numlayers != 1:
        # only the 1-layer attention LSTM of rnn_attention.py:25 is
        # implemented; the other variants never read the knob
        raise NotImplementedError(
            f"rnn_attention_numlayers={cf.rnn_attention_numlayers} — only 1 "
            "layer is implemented"
        )
    if cf.atten_model_name not in LSTM_VARIANTS:  # a hybrid LM decoder
        if cf.encoder_quant != "none":
            raise unsupported(cf.atten_model_name, f"encoder_quant={cf.encoder_quant!r}")
        from adaptive_tpu_torch.models.hybrid_lm import lm_spec

        lm_spec(cf)  # raises on an unknown or unsupported hybrid_lm key
