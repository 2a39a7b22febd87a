from adaptive_tpu_torch.models.factory import CaptionModel, Encoder2Decoder, build_model

__all__ = ["CaptionModel", "Encoder2Decoder", "build_model"]
