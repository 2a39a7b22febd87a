from adaptive_tpu_torch.decoding.greedy import GreedyOutput, make_greedy_decoder

__all__ = ["GreedyOutput", "make_greedy_decoder"]
