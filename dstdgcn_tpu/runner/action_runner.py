"""Per-action runner for Human3.6M and CMU Mocap.

One implementation covers the reference ``H36MRunner`` (runner/h36m.py) and
``CMURunner`` (runner/cmu.py) — they differ only in action lists (supplied
by the dataset registry) and scaler plumbing, both handled generically.
Behavior parity: train epoch -> per-action evaluation at the configured
horizons -> ``training_loss.csv`` append -> last/best checkpointing; test
modes produce ``testing_loss.csv`` with per-action per-horizon columns.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from ..data import Loader, define_actions, get_dataset
from .base import BaseRunner, write_csv

_HORIZON_HEADS_LONG = ["3d80", "3d160", "3d320", "3d400", "3d560", "3d720",
                       "3d880", "3d1000"]
_HORIZON_HEADS_SHORT = ["3d80", "3d160", "3d320", "3d400"]


class ActionRunner(BaseRunner):

    def _horizon_heads(self) -> List[str]:
        return (_HORIZON_HEADS_LONG
                if self.config["setting"]["output_n"] > 10
                else _HORIZON_HEADS_SHORT)

    def _build_test_loaders(self, test_acts, scaler=None) -> Dict[str, Loader]:
        name = self.config["dataset"]["name"]
        test_cfg = self.config["dataset"]["test"]
        loaders = {}
        for act in test_acts:
            test_cfg[name]["actions"] = act
            if scaler is not None:
                test_cfg[name]["scaler"] = scaler
            ds = get_dataset(name, **test_cfg)
            loaders[act] = Loader(ds.arrays(),
                                  self.config["test_batch_size"],
                                  shuffle=False)
            self._last_test_dataset = ds
        return loaders

    def _eval_all_actions(self, test_acts, loaders, time_tsfm, scale_tsfm,
                          save_prefix=None):
        setting = self.config["setting"]
        heads = self._horizon_heads()
        err_avg, err_all = 0.0, np.zeros(len(heads))
        ret = np.zeros(1 + len(heads))
        head = ["test_loss"] + heads
        for act in test_acts:
            a_avg, a_all = self.engine.test(
                loaders[act], setting["input_n"],
                np.array(setting["eval_frame"]),
                np.array(setting["dim_used"]),
                (np.array(setting["joint_to_ignore"])
                 if setting.get("joint_to_ignore") is not None else None),
                (np.array(setting["joint_to_equal"])
                 if setting.get("joint_to_equal") is not None else None),
                time_tsfm, scale_tsfm, act,
                (save_prefix + act) if save_prefix else None)
            err_avg += a_avg
            err_all += a_all
            ret = np.append(ret, a_all)
            head += [act + h for h in heads]
        err_avg /= len(test_acts)
        err_all /= len(test_acts)
        ret[0] = err_avg
        ret[1:len(err_all) + 1] = err_all
        return err_avg, err_all, ret, head

    def run_train(self):
        self.logger.info("Start training")
        cfg = self.config
        name = cfg["dataset"]["name"]
        train_cfg = cfg["dataset"]["train"]
        debug = "debug" in cfg["mode"]
        test_acts = define_actions("debug" if debug else "all", name)
        train_cfg[name]["actions"] = "debug" if debug else "all"
        if "mode" in train_cfg[name]:
            train_cfg[name]["mode"] = "debug" if debug else "train"
        train_dataset = get_dataset(name, **train_cfg)
        self.logger.info(
            "train data shape {}".format(train_dataset.all_seqs.shape[0]))
        train_loader = Loader(train_dataset.arrays(),
                              cfg["train_batch_size"], shuffle=True)
        test_loaders = self._build_test_loaders(
            test_acts, scaler=train_dataset.scale_tsfm)

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
                train_loader, epoch, train_dataset.time_tsfm,
                train_dataset.scale_tsfm,
                (train_dataset.joint_weight_use
                 if cfg["engine"]["use_weight"] else None),
                cfg["engine"]["max_iter"])

            err_avg, _, ret_test, head_test = self._eval_all_actions(
                test_acts, test_loaders, train_dataset.time_tsfm,
                train_dataset.scale_tsfm)

            ret_log = np.concatenate(
                [[epoch + 1, self.engine.lr, train_loss], ret_test])
            head = ["epoch", "lr", "train_loss"] + head_test
            self._append_csv("training_loss.csv", ret_log, head,
                             first=(epoch == start_epoch))

            is_best = (not np.isnan(err_avg)) and err_avg < err_best
            err_best = min(err_avg, err_best) if not np.isnan(err_avg) \
                else err_best
            self.engine.save(cfg["save"]["path"]["checkpoints"], err_avg,
                             epoch, is_best)
            if is_best:
                ret_log_best = ret_log
            self.logger.info(
                ">>> epoch: {} | loss: {:.5f} | best: {:.5f}".format(
                    epoch + 1, err_avg, err_best))

        if ret_log_best is not None:
            self._append_csv("training_loss.csv", ret_log_best, None,
                             first=False)

    def run_test(self):
        self.logger.info("Start testing")
        cfg = self.config
        name = cfg["dataset"]["name"]
        debug = "debug" in cfg["mode"]
        test_acts = define_actions("debug" if debug else "all", name)
        scaler = None
        if cfg["dataset"].get("scale"):
            train_cfg = cfg["dataset"]["train"]
            train_cfg[name]["scale"] = True
            train_dataset = get_dataset(name, **train_cfg)
            scaler = train_dataset.scale_tsfm
            cfg["dataset"]["test"][name]["scale"] = True
        test_loaders = self._build_test_loaders(test_acts, scaler=scaler)
        ds = self._last_test_dataset

        self.engine.init(ds.input_seqs[:1])
        if cfg["model"].get("load"):
            self.engine.recover(cfg["model"]["ckpt"])

        save_prefix = (cfg["save"]["path"]["visualize"]
                       if cfg["setting"].get("save") else None)
        err_avg, _, ret_test, head_test = self._eval_all_actions(
            test_acts, test_loaders, ds.time_tsfm, ds.scale_tsfm,
            save_prefix)
        self.logger.info("Loss: {:.5f}".format(err_avg))
        out = os.path.join(cfg["save"]["path"]["base"], "testing_loss.csv")
        write_csv(out, [ret_test], head_test)
        self.logger.info("Save result to " + out)

    def run_test_all(self):
        """Per-frame metric over every output frame (runner/h36m.py:263-346)."""
        self.logger.info("Start testing all")
        cfg = self.config
        name = cfg["dataset"]["name"]
        debug = "debug" in cfg["mode"]
        test_acts = define_actions("debug" if debug else "all", name)
        scaler = None
        if cfg["dataset"].get("scale"):
            train_cfg = cfg["dataset"]["train"]
            train_cfg[name]["scale"] = True
            train_dataset = get_dataset(name, **train_cfg)
            scaler = train_dataset.scale_tsfm
        test_loaders = self._build_test_loaders(test_acts, scaler=scaler)
        ds = self._last_test_dataset

        self.engine.init(ds.input_seqs[:1])
        if cfg["model"].get("load"):
            self.engine.recover(cfg["model"]["ckpt"])

        output_n = cfg["setting"]["output_n"]
        head = ["action", "avg"] + [str((i + 1) * 40) for i in range(output_n)]
        rows = []
        accum_avg, accum_all, total = 0.0, np.zeros(output_n), 0
        # setting.save dumps per-action prediction npz files to the
        # visualize path, as the reference test-all does (runner/h36m.py:317)
        save_prefix = (cfg["save"]["path"]["visualize"]
                       if cfg["setting"].get("save") else None)
        for act in test_acts:
            a_avg, a_all = self.engine.test(
                test_loaders[act], cfg["setting"]["input_n"],
                np.arange(output_n), np.array(cfg["setting"]["dim_used"]),
                (np.array(cfg["setting"]["joint_to_ignore"])
                 if cfg["setting"].get("joint_to_ignore") is not None
                 else None),
                (np.array(cfg["setting"]["joint_to_equal"])
                 if cfg["setting"].get("joint_to_equal") is not None
                 else None),
                ds.time_tsfm, ds.scale_tsfm, act,
                (save_prefix + act) if save_prefix else None)
            w = len(test_loaders[act])
            accum_avg += a_avg * w
            accum_all += a_all * w
            total += w
            rows.append([act, a_avg] + list(a_all))
        rows.append(["average", accum_avg / total] +
                    list(accum_all / total))
        out = os.path.join(cfg["save"]["path"]["base"], "testing_loss.csv")
        write_csv(out, rows, head)
        self.logger.info("Loss: {:.5f}".format(accum_avg / total))
        self.logger.info("Save result to " + out)

    def _append_csv(self, filename, row, head, first):
        out = os.path.join(self.config["save"]["path"]["base"], filename)
        write_csv(out, [row], head if first else None, append=not first)


class H36MRunner(ActionRunner):
    pass


class CMURunner(ActionRunner):
    pass
