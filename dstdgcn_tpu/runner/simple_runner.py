"""Single-split runner for 3DPW and the synthetic dataset.

Parity with reference ``PW3DRunner`` (runner/pw3d.py): one test loader
(no per-action split), PGBIG-protocol horizons for 3DPW, per-epoch CSV and
best-checkpoint tracking.  Also used for the file-free ``synthetic``
dataset powering the CPU-sized end-to-end configs.
"""

from __future__ import annotations

import os

import numpy as np

from ..data import Loader, get_dataset
from .base import BaseRunner, write_csv


class SimpleRunner(BaseRunner):

    def _heads(self):
        frames = self.config["setting"]["eval_frame"]
        return ["test_loss"] + [f"3d{(f + 1) * 40}" for f in frames]

    def _test_once(self, test_loader, ds, save_path=None):
        setting = self.config["setting"]
        jti = setting.get("joint_to_ignore")
        jte = setting.get("joint_to_equal")
        return self.engine.test(
            test_loader, setting["input_n"], np.array(setting["eval_frame"]),
            np.array(setting["dim_used"]),
            np.array(jti) if jti is not None else None,
            np.array(jte) if jte is not None else None,
            ds.time_tsfm, None, "all", save_path)

    def run_train(self):
        self.logger.info("Start training")
        cfg = self.config
        name = cfg["dataset"]["name"]
        train_dataset = get_dataset(name, **cfg["dataset"]["train"])
        self.logger.info("train data shape {}".format(len(train_dataset)))
        train_loader = Loader(train_dataset.arrays(),
                              cfg["train_batch_size"], shuffle=True)
        test_dataset = get_dataset(name, **cfg["dataset"]["test"])
        self.logger.info("test data shape {}".format(len(test_dataset)))
        test_loader = Loader(test_dataset.arrays(), cfg["test_batch_size"],
                             shuffle=False)

        self.engine.init(train_dataset.input_seqs[:1])
        if cfg["model"].get("load"):
            start_epoch, err_best = self.engine.recover(cfg["model"]["ckpt"])
        else:
            start_epoch, err_best = 0, 1e10

        ret_log_best = None
        for epoch in range(start_epoch, cfg["epoch"]):
            self.logger.info("==========================")
            self.logger.info(">>> epoch: {} | lr: {:.5f}".format(
                epoch + 1, self.engine.lr_schedule(epoch)))
            train_loader.set_epoch(epoch)
            train_loss = self.engine.train(
                train_loader, epoch, train_dataset.time_tsfm, None, None,
                cfg["engine"]["max_iter"])
            err_avg, err_all = self._test_once(test_loader, test_dataset)

            ret_log = np.concatenate([[epoch + 1, self.engine.lr,
                                       train_loss], [err_avg], err_all])
            head = (["epoch", "lr", "train_loss"] + self._heads())
            out = os.path.join(cfg["save"]["path"]["base"],
                               "training_loss.csv")
            first = epoch == start_epoch
            write_csv(out, [ret_log], head if first else None,
                      append=not first)

            is_best = (not np.isnan(err_avg)) and err_avg < err_best
            if not np.isnan(err_avg):
                err_best = min(err_avg, err_best)
            self.engine.save(cfg["save"]["path"]["checkpoints"], err_avg,
                             epoch, is_best)
            if is_best:
                ret_log_best = ret_log
            self.logger.info(
                ">>> epoch: {} | loss: {:.5f} | best: {:.5f}".format(
                    epoch + 1, err_avg, err_best))

        if ret_log_best is not None:
            out = os.path.join(cfg["save"]["path"]["base"],
                               "training_loss.csv")
            write_csv(out, [ret_log_best], append=True)

    def run_test(self):
        self.logger.info("Start testing")
        cfg = self.config
        name = cfg["dataset"]["name"]
        test_dataset = get_dataset(name, **cfg["dataset"]["test"])
        test_loader = Loader(test_dataset.arrays(), cfg["test_batch_size"],
                             shuffle=False)
        self.logger.info(
            "test data shape {}".format(test_dataset.all_seqs.shape[0]))
        self.engine.init(test_dataset.input_seqs[:1])
        if cfg["model"].get("load"):
            self.engine.recover(cfg["model"]["ckpt"])
        save_path = (cfg["save"]["path"]["visualize"] + "all"
                     if cfg["setting"].get("save") else None)
        err_avg, err_all = self._test_once(test_loader, test_dataset,
                                           save_path)
        ret = np.concatenate([[err_avg], err_all])
        self.logger.info("Loss: {:.5f}".format(err_avg))
        out = os.path.join(cfg["save"]["path"]["base"], "testing_loss.csv")
        write_csv(out, [ret], self._heads())
        self.logger.info("Save result to " + out)

    def run_test_all(self):
        raise NotImplementedError

    def run_visualize(self):
        from ..utils.visualization import Visualizer
        cfg = self.config
        name = cfg["dataset"]["name"]
        test_dataset = get_dataset(name, **cfg["dataset"]["test"])
        vis = Visualizer(self.dataset)
        for i in range(len(test_dataset)):
            vis.plot_single(test_dataset.all_seqs[i],
                            cfg["save"]["path"]["visualize"],
                            f"S{i + 1}", cfg["setting"]["input_n"])


class PW3DRunner(SimpleRunner):
    pass


class SyntheticRunner(SimpleRunner):
    pass
