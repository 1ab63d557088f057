"""Dual-sink run logger with the reference's run-id scheme.

Copy of ``neurec_tpu/logging.py`` (util/logger.py:10-70: file + stdout
sinks, eager flush; model/AbstractRecommender.py:9-20: log path
``log/<dataset>/<model>/<dataset>_<params>_<timestamp>.log``).
"""

from __future__ import annotations

import logging
import os
import sys
import time


class Logger:
    def __init__(self, filename: str):
        dir_name = os.path.dirname(filename)
        if dir_name and not os.path.exists(dir_name):
            os.makedirs(dir_name, exist_ok=True)
        self.path = filename

        self.logger = logging.getLogger(filename)
        self.logger.setLevel(logging.DEBUG)
        self.logger.handlers.clear()
        self.logger.propagate = False

        formatter = logging.Formatter("%(message)s")

        self.file_handler = logging.FileHandler(filename, encoding="utf-8")
        self.file_handler.setLevel(logging.DEBUG)
        self.file_handler.setFormatter(formatter)

        self.console_handler = logging.StreamHandler(sys.stdout)
        self.console_handler.setLevel(logging.DEBUG)
        self.console_handler.setFormatter(formatter)

        self.logger.addHandler(self.file_handler)
        self.logger.addHandler(self.console_handler)

    def _flush(self):
        self.file_handler.flush()
        self.console_handler.flush()

    def debug(self, message: str):
        self.logger.debug(message)
        self._flush()

    def info(self, message: str):
        self.logger.info(message)
        self._flush()

    def warning(self, message: str):
        self.logger.warning(message)
        self._flush()

    def error(self, message: str):
        self.logger.error(message)
        self._flush()

    def critical(self, message: str):
        self.logger.critical(message)
        self._flush()


def run_logger(config, dataset_name: str, root: str = "log") -> Logger:
    """Create the per-run logger used by the trainer.

    Mirrors model/AbstractRecommender.py:9-20: one log file per run under
    ``log/<dataset>/<model>/``, named from the hyperparameter string and a
    timestamp.
    """
    model_name = config["recommender"]
    log_dir = os.path.join(root, dataset_name, model_name)
    timestamp = time.time()
    params = config.params_str()
    run_id = "%s_%.8f" % (params[:150], timestamp)
    return Logger(os.path.join(log_dir, run_id + ".log"))
