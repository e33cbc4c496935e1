"""Run logging: paired file + screen loggers for training runs (JAX twin:
idvs/morec_tpu/utils/logging.py, copied).

Only the *line formats* and the log-file naming scheme follow the reference
output (so downstream log-parsing tooling sees identical lines — parameter
audit, step/loss cadence, timing reports, metric rows; reference
data_utils/utils.py:92-133, metrics.py:25-26). The module structure is this
project's own: one logger factory, an epoch-step budget helper, and small
report writers the Trainer composes.
"""

from __future__ import annotations

import logging
import math
import os
import time

_FMT = logging.Formatter("[%(levelname)s %(asctime)s] %(message)s")


def _fresh_logger(name: str) -> logging.Logger:
    lg = logging.getLogger(name)
    lg.handlers.clear()          # idempotent across repeat runs in one process
    lg.setLevel(logging.INFO)
    return lg


def _run_log_path(dir_label: str, log_paras: str, time_run: str, mode: str,
                  behaviors: str) -> str:
    """Reference log-file naming (utils.py:24-40): train runs get their own
    logs_<label>_train/ directory; test/other runs log beside the cwd."""
    if "train" in mode:
        d = "./logs_" + dir_label + "_train"
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, "log_" + log_paras + time_run + ".log")
    prefix = "test" if "test" in mode else "other"
    return f"log_{prefix}_all_{behaviors.split('_')[0]}.log"


def setuplogger(dir_label: str, log_paras: str, time_run: str, mode: str,
                behaviors: str = ""):
    """Build the (file, screen) logger pair. The file logger also echoes to
    the screen; the screen logger is for short progress lines only."""
    log_file = _fresh_logger("Log_file")
    log_screen = _fresh_logger("Log_screen")

    to_file = logging.FileHandler(
        filename=_run_log_path(dir_label, log_paras, time_run, mode, behaviors),
        encoding="utf-8")
    to_screen = logging.StreamHandler()
    for h in (to_file, to_screen):
        h.setFormatter(_FMT)
    log_file.addHandler(to_file)
    log_file.addHandler(to_screen)
    log_screen.addHandler(to_screen)
    return log_file, log_screen


def _hms(seconds: float):
    s = int(seconds)
    return s // 3600, (s // 60) % 60, s % 60


def _time_line(log, label: str, seconds: float) -> None:
    h, m, s = _hms(seconds)
    log.info("##### (time) {}: {} hours {} minutes {} seconds #####".format(
        label, h, m, s))


def para_and_log(n_params_total: int, n_params_trainable: int, seq_num: int,
                 batch_size: int, log_file, logging_num: int,
                 testing_num: int):
    """Parameter audit + per-epoch log/test cadence (utils.py:92-104 lines).

    Returns (steps between loss logs, steps between mid-epoch tests)."""
    log_file.info("##### total_num {} #####".format(n_params_total))
    log_file.info("##### trainable_num {} #####".format(n_params_trainable))
    steps_per_epoch = math.ceil(seq_num / batch_size)
    log_file.info("##### all {} steps #####".format(steps_per_epoch))
    every_log = max(1, steps_per_epoch // logging_num)
    every_test = max(1, steps_per_epoch // testing_num)
    log_file.info("##### {} logs/epoch; {} steps/log #####".format(
        logging_num, every_log))
    return every_log, every_test


def report_time_train(batch_index: int, now_epoch: int, loss_sum: float,
                      epoch_start_time: float, run_start_time: float,
                      log_file) -> float:
    """End-of-epoch summary; returns the next epoch's start timestamp."""
    log_file.info("epoch: {} end, train_loss: {:.5f}".format(
        now_epoch, loss_sum / max(batch_index, 1)))
    now = time.time()
    _time_line(log_file, "this epoch set", now - epoch_start_time)
    _time_line(log_file, "start until now", now - run_start_time)
    return time.time()


def report_time_eval(start_time: float, log_file) -> None:
    _time_line(log_file, "eval(valid and test)", time.time() - start_time)


def print_metrics(values, log_file, v_or_t: str) -> None:
    """Metric row, reference metrics.py:25-26 format (values are fractions,
    printed x100)."""
    log_file.info(v_or_t + "_results   {}".format(
        "\t".join("{:0.5f}".format(v * 100) for v in values)))


def get_time(start_time: float, end_time: float):
    """Elapsed (hours, minutes, seconds) between two timestamps."""
    return _hms(end_time - start_time)
