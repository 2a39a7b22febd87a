from adaptive_tpu_torch.decoding.beam import BeamOutput, make_beam_decoder
from adaptive_tpu_torch.decoding.greedy import GreedyOutput, make_greedy_decoder

__all__ = ["BeamOutput", "GreedyOutput", "make_beam_decoder", "make_greedy_decoder"]
