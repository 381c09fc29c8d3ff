"""Experiment runners: orchestration of datasets, engine, and evaluation.

Parity with the reference runner layer (``runner/base.py``, ``runner/h36m.py``
etc.): mode dispatch (train / test / test-all / visualize, each with a
``-debug`` variant), per-action evaluation sweeps, per-epoch CSV metric
logging, best-checkpoint tracking, and source-file snapshotting into the run
directory.
"""

from __future__ import annotations

import csv
import math
import os
import random
import shutil
from typing import Iterable, Optional, Sequence

import numpy as np

from ..data import Loader, define_actions, get_dataset
from ..engine import PredictionEngine
from ..graphs import bone_incidence
from ..models import get_model


def setup_seed(seed: int) -> None:
    np.random.seed(seed)
    random.seed(seed)


def _csv_cell(v) -> str:
    """Cell text as the metric CSVs have always had it: the shortest
    round-trip repr of a float, an empty cell for NaN."""
    if isinstance(v, (float, np.floating)):
        return "" if math.isnan(v) else repr(float(v))
    if isinstance(v, np.integer):
        return str(int(v))
    return str(v)


def write_csv(path: str, rows: Iterable[Sequence],
              header: Optional[Sequence[str]] = None,
              append: bool = False) -> None:
    """Write (or append) metric rows, optionally under a header line."""
    with open(path, "a" if append else "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        if header is not None:
            w.writerow(header)
        w.writerows([_csv_cell(v) for v in row] for row in rows)


class BaseRunner:
    """Builds model + engine (for train/test modes) and dispatches on mode
    (reference runner/base.py:22-131)."""

    def __init__(self, config):
        self.config = config
        self.logger = config["logger"]
        self.dataset = config["dataset"]["name"]

        if "t" in self.config["mode"]:
            model_opts = {k: v for k, v in dict(config["model"]).items()
                          if k != "name"}
            model_name = config["model"]["name"]
            layout = model_opts.get(model_name, {}).get("layout")
            # pin "auto" knob resolution to the configured train batch so
            # ragged final batches / eval shapes don't flip the knobs
            # mid-run (models/autotune.py resolve_knob)
            if "auto" in str(dict(model_opts.get(model_name, {})).values()):
                model_opts.setdefault(
                    "auto_batch_hint", int(config["train_batch_size"]))
            model = get_model(model_name, **model_opts)
            inc = None
            if layout is not None:
                try:
                    inc = bone_incidence(layout)
                except NotImplementedError:
                    inc = None
            mesh, data_sharding = self._build_mesh()
            if config["engine"].get("callbacks"):
                config["engine"]["callbacks"].setdefault(
                    "log_dir", config["save"]["path"]["base"])
            self.engine = PredictionEngine(config["engine"], model,
                                           self.logger, bone_incidence=inc,
                                           mesh=mesh,
                                           data_sharding=data_sharding)
        self.save_files()
        setup_seed(777)

    # -- infrastructure ---------------------------------------------------

    def _build_mesh(self):
        """Build the (data, graph) device mesh from the optional ``parallel``
        config block: ``parallel: {data: auto|int, graph: int}``.  An
        absent block means single-device semantics (mesh=None); a block
        that asks for more devices than are present is an error."""
        par = self.config.get("parallel")
        if not par:
            return None, None
        import jax

        from ..parallel import batch_sharding, make_mesh
        graph = int(par.get("graph", 1))
        model = int(par.get("model", 1))
        data = par.get("data", "auto")
        data = None if data in ("auto", None, "None") else int(data)
        n_dev = len(jax.devices())
        want = (data or n_dev // (graph * model)) * graph * model
        if want == 0 or want > n_dev or (
                data is None and n_dev % (graph * model) != 0):
            raise ValueError(
                f"parallel config asks for data={par.get('data', 'auto')} x "
                f"graph={graph} x model={model} devices but {n_dev} "
                f"{jax.devices()[0].platform} device(s) are present")
        mesh = make_mesh(data=data, graph=graph, model=model)
        self.logger.info(f"device mesh: {dict(mesh.shape)}")
        return mesh, batch_sharding(mesh)

    def save_files(self) -> None:
        for path in list(self.config["save"]["path"].keys()):
            if path != "base":
                update = os.path.join(self.config["save"]["path"]["base"],
                                      self.config["save"]["path"][path])
                self.config["save"]["path"][path] = update
                os.makedirs(update, exist_ok=True)
        for file in self.config["save"].get("files", []):
            if os.path.exists(file):
                shutil.copy(file, self.config["save"]["path"]["files"])

    def _loader(self, dataset, batch_size, shuffle):
        # under a multi-host launch each process gathers only its shard of
        # every (global) batch; ragged final batches are dropped so all
        # processes assemble equal-sized global arrays
        from ..parallel.distributed import process_info
        pi, pc = process_info()
        return Loader(dataset.arrays(), batch_size, shuffle=shuffle,
                      drop_last=pc > 1, process_index=pi, process_count=pc)

    def _init_engine(self, sample_loader) -> None:
        inputs = sample_loader.arrays[0] if isinstance(
            sample_loader, Loader) else sample_loader
        self.engine.init(np.asarray(inputs[:1], np.float32))
        if self.config["model"].get("load"):
            pass  # recover happens in run_* with epoch bookkeeping

    # -- visualization ----------------------------------------------------

    def run_visualize(self):
        from ..utils.visualization import Visualizer
        dataset_name = self.config["dataset"]["name"]
        train_cfg = self.config["dataset"]["train"]
        if "debug" in self.config["mode"]:
            test_acts = define_actions("debug", dataset_name)
            train_cfg[dataset_name]["actions"] = "debug"
        else:
            test_acts = define_actions("all", dataset_name)
            train_cfg[dataset_name]["actions"] = "all"
        train_dataset = get_dataset(dataset_name, **train_cfg)
        test_cfg = self.config["dataset"]["test"]
        test_cfg[dataset_name]["scaler"] = train_dataset.scale_tsfm
        vis = Visualizer(self.dataset)
        for act in test_acts:
            test_cfg[dataset_name]["actions"] = act
            test_dataset = get_dataset(dataset_name, **test_cfg)
            for i in range(len(test_dataset)):
                seq = test_dataset.all_seqs[i]
                vis.plot_single(seq, self.config["save"]["path"]["visualize"],
                                f"A{act}_S{i + 1}",
                                self.config["setting"]["input_n"])
                if i + 1 >= 8:
                    break

    def run(self):
        mode = self.config["mode"]
        if "train" in mode:
            self.run_train()
        elif "test" in mode:
            if "visualize" in mode:
                self.config["setting"]["save"] = True
            if "all" in mode:
                self.run_test_all()
            else:
                self.run_test()
        else:
            self.run_visualize()

    def run_train(self):
        raise NotImplementedError

    def run_test(self):
        raise NotImplementedError

    def run_test_all(self):
        raise NotImplementedError
