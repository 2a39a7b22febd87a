from adaptive_tpu_torch.training.train_loop import main_train

__all__ = ["main_train"]
