from adaptive_tpu_torch.data.tokenizer import caption_tokenize
from adaptive_tpu_torch.data.vocab import Vocabulary, build_vocab

__all__ = ["Vocabulary", "build_vocab", "caption_tokenize"]
