"""decode_loop_ms.decode: ms a batch outside the encoder: a whole decode's
CUDA-event ms less encoder_ms.decode's, on the same batch on the card."""

from benchmark.lib.readings import decode_times


def read(ctx):
    t = decode_times(ctx)
    return None if t is None else t["batch_ms"] - t["encoder_ms"]
