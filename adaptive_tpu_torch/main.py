"""Command-line entry: the pipeline's stages gated by config flags
(counterpart of adaptive_tpu/main.py).

    python -m adaptive_tpu_torch.main -c <config.py | config.json>

Reference parity: main.py:15-69: one ``-c/--config_path`` argument, the
stages run in order resize -> Karpathy split -> vocab build -> train ->
valid -> test, with the start, end and elapsed-time lines. The config loads
through ``load_config``; ``Experiment`` makes the experiment dir, tees
stdout into its ``logfile.log`` and writes ``config.json``, and is torn down
however the stages end.

The stages run on the card (``device="cuda"``) and raise where there is
none; ``main(argv, device="cpu")`` runs them on the CPU, as the tests do.
There is no flag for the device: the JAX package takes its platform from
the environment. ``image_source`` (a callable: file path -> uint8 HWC array)
reads the resized images in place of the JPEG decode, for a machine without
Pillow (ROADMAP.md §3).

Several cards: one process each, started by torchrun,

    torchrun --nproc_per_node=N -m adaptive_tpu_torch.main -c configs/coco_adaptive_v5e8.py

torchrun's WORLD_SIZE > 1 (or ``distributed_init``) starts the default
process group, nccl on the card (each rank on its LOCAL_RANK card), gloo on
the CPU, and the stages run over the config's mesh (parallel/mesh.py). The
ranks share rank 0's experiment dir; rank r > 0 tees into
``logfile.proc<r>.log``.
"""

from __future__ import annotations

import argparse
import time
from datetime import datetime

import torch

from adaptive_tpu_torch.config import Config, load_config
from adaptive_tpu_torch.experiment import Experiment
from adaptive_tpu_torch.models.factory import resolve_device
from adaptive_tpu_torch.parallel.mesh import get_rank, get_world_size, init_distributed
from adaptive_tpu_torch.utils.logging import HMS, configurationPATH


def process(cf: Config, device="cuda", image_source=None):
    """Run the enabled stages in order (in a process group where
    cf.distributed_init or torchrun asks for one: parallel/mesh.py::
    init_distributed)."""
    resolve_device(device)  # no card: raise before any stage runs
    init_distributed(cf, device)
    if cf.resizeOrnot:
        print(">---------resize images---------<")
        from adaptive_tpu_torch.data.resize import main_resize_images

        main_resize_images(cf)

    if cf.KarpathySplitOrnot:
        print(">---------KarpathySplit---------<")
        from adaptive_tpu_torch.data.karpathy_split import main_KarpathySplit

        main_KarpathySplit(cf)

    if cf.vacab_build_Ornot:
        print(">---------vocal build---------<")
        from adaptive_tpu_torch.data.vocab import main_build_vocab

        main_build_vocab(cf)

    if cf.trainOrnot:
        print(">---------start train---------<")
        from adaptive_tpu_torch.training.train_loop import main_train

        main_train(cf, device=device, image_source=image_source)

    if cf.validOrnot:
        print(">---------start valid---------<")
        from adaptive_tpu_torch.evalcap.coco_eval import coco_eval

        coco_eval(cf, valid_mode=True, device=device, image_source=image_source)

    if cf.testOrnot:
        print(">---------start test---------<")
        from adaptive_tpu_torch.evalcap.coco_eval import coco_eval

        coco_eval(cf, test_mode=True, device=device, image_source=image_source)


def main(argv=None, device="cuda", image_source=None):
    parser = argparse.ArgumentParser(description="Model training")
    parser.add_argument("-c", "--config_path", type=str, required=True,
                        help="Configuration file (.py or .json)")
    args = parser.parse_args(argv)
    resolve_device(device)  # no card: raise before the experiment dir is made

    print("\n > Start Time:")
    print("   " + datetime.now().strftime("%a, %d %b %Y-%m-%d %H:%M:%S"))
    start_time = time.time()

    cf = load_config(args.config_path)
    started = init_distributed(cf, device)
    exp = Experiment(cf)
    cf = exp.setup(stamp=_shared_stamp(), rank=get_rank())
    configurationPATH(cf)

    try:
        process(cf, device=device, image_source=image_source)
    finally:
        exp.teardown()
        if started:
            torch.distributed.destroy_process_group()

    end_time = time.time()
    print("\n > End Time:")
    print("   " + datetime.now().strftime("%a, %d %b %Y-%m-%d %H:%M:%S"))
    print("\n   ET: " + HMS(end_time - start_time))


def _shared_stamp():
    """Rank 0's timestamp for the experiment dir, on every rank (None: the
    dir's own, in one process)."""
    if get_world_size() <= 1:
        return None
    box = [datetime.now().strftime("%Y-%m-%d-%H-%M-%S")]
    torch.distributed.broadcast_object_list(box, src=0)
    return box[0]


if __name__ == "__main__":
    main()
