#!/usr/bin/env python
"""CLI entry point: run a skeleton-prediction experiment.

Parity with reference ``main.py:8-40``:
    python main.py --exp_name NAME --run_dir DIR --config CONFIG.yaml
"""

import argparse
import os
import os.path as path

from dstdgcn_tpu.runner import get_runner
from dstdgcn_tpu.utils.compile_cache import enable_compile_cache
from dstdgcn_tpu.utils.config import get_config, save_config
from dstdgcn_tpu.utils.logging import setup_logger


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Running a skeleton prediction network.")
    parser.add_argument("--exp_name", default="test_model", type=str,
                        help="experiment name")
    parser.add_argument("--run_dir", default="run/", type=str,
                        help="result dir")
    parser.add_argument("--config", default="configs/config.yaml",
                        help="config file")
    args = parser.parse_args(argv)

    opts = get_config(args.config)
    opts["save"]["path"]["base"] = args.run_dir
    os.makedirs(args.run_dir, exist_ok=True)
    enable_compile_cache()

    # multi-host launch (SURVEY §7 step 8): initialize jax.distributed
    # BEFORE any device query so jax.devices() is the global set; a missing
    # config block / env means single-process (no-op, rank 0)
    from dstdgcn_tpu.parallel import distributed as dist
    rank, _ = dist.initialize(
        (opts.get("parallel") or {}).get("distributed"))

    logger = setup_logger("prediction", args.run_dir, rank)
    logger.info(f"Pid: {os.getpid()}")

    if "test" not in opts["mode"]:
        save_config(opts, path.join(args.run_dir, "train_options.yaml"),
                    True, logger)

    opts["logger"] = logger
    runner = get_runner(opts["runner"], opts)
    runner.run()
    return runner


if __name__ == "__main__":
    main()
