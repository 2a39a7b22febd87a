"""Experiment directory and stdout tee (counterpart of
adaptive_tpu/config/experiment.py).

Reference parity: Configuration.load() builds a timestamped experiment dir
named from the enabled stage flags and redirects sys.stdout to a tee Logger
writing logfile.log (reference code_src/config/configuration.py:7-60). Here
the same behaviour is explicit and reversible, and the config dump is a JSON
snapshot (``config.json``) instead of ``print(help(cf))``
(configuration.py:38).
"""

from __future__ import annotations

import os
import sys
from datetime import datetime
from typing import Optional

from adaptive_tpu_torch.config import Config


class Logger:
    """stdout tee: writes to the terminal and to a logfile (configuration.py:7-17)."""

    def __init__(self, log_file: str):
        self.terminal = sys.stdout
        self.log = open(log_file, "a")

    def write(self, message: str):
        self.terminal.write(message)
        self.log.write(message)

    def flush(self):
        self.terminal.flush()
        self.log.flush()

    def close(self):
        self.log.close()


def get_model_description(cf: Config) -> str:
    """Experiment-dir name from the enabled stage flags (configuration.py:42-60)."""
    d = ""
    if cf.resizeOrnot:
        d += "resize_images_size_" + str(cf.resized_image_size)
    if cf.vacab_build_Ornot:
        d += "build_vocabulary_vocab_threshold" + str(cf.vocab_threshold)
    if cf.KarpathySplitOrnot:
        d += "Karpathy_Split"
    if cf.trainOrnot:
        if cf.train_pretrained:
            d += "Train_" + cf.train_pretrained_model.replace("/", "_").split(".")[0]
        else:
            d += "Train_" + cf.atten_model_name
    if cf.testOrnot:
        d += "Test_" + cf.test_pretrained_model.replace("/", "_").split(".")[0]
    if cf.validOrnot:
        d += "Valid_" + cf.valid_pretrained_model.replace("/", "_").split(".")[0]
    return d or "run"


class Experiment:
    """Owns the experiment directory, the log tee and the config snapshot."""

    def __init__(self, cf: Config):
        self.cf = cf
        self._logger: Optional[Logger] = None
        self._saved_stdout = None

    def setup(self, stamp: Optional[str] = None, rank: int = 0) -> Config:
        """Make '<experiment_path>/<description>___<timestamp>/', start the
        tee into its logfile.log, write config.json; returns the Config with
        exp_dir, model_description and log_file filled in. stamp: the
        timestamp (default now); the ranks of a process group pass rank 0's,
        and rank r > 0 tees into logfile.proc<r>.log and leaves config.json
        to rank 0."""
        cf = self.cf
        desc = get_model_description(cf)
        stamp = stamp or datetime.now().strftime("%Y-%m-%d-%H-%M-%S")
        exp_dir = os.path.join(cf.experiment_path, desc + "_" * 3 + stamp)
        os.makedirs(exp_dir, exist_ok=True)
        log_file = os.path.join(exp_dir, "logfile.log" if rank == 0 else f"logfile.proc{rank}.log")
        cf = cf.replace(exp_dir=exp_dir, model_description=desc, log_file=log_file)
        self._saved_stdout = sys.stdout
        self._logger = Logger(log_file)
        sys.stdout = self._logger
        if rank == 0:
            with open(os.path.join(exp_dir, "config.json"), "w") as f:
                f.write(cf.to_json())
        self.cf = cf
        return cf

    def teardown(self):
        if self._logger is not None:
            sys.stdout = self._saved_stdout
            self._logger.close()
            self._logger = None
