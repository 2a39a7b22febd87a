from adaptive_tpu_torch.evalcap.eval import COCOEvalCap

__all__ = ["COCOEvalCap"]
