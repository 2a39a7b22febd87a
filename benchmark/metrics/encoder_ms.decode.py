"""encoder_ms.decode: ms a batch of the encoder alone (preprocess, the
BN-folded trunk, the heads), by CUDA events around the port's
encode_inference(prepare(net), eval_preprocess(images)) on a batch already
on the card."""

from benchmark.lib.readings import decode_times


def read(ctx):
    t = decode_times(ctx)
    return None if t is None else t["encoder_ms"]
