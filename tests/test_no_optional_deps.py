"""The main path needs none of flax, PyYAML, pandas or msgpack."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = textwrap.dedent('''
    import os, sys
    BLOCKED = ("flax", "yaml", "pandas", "msgpack")
    for name in BLOCKED:
        sys.modules[name] = None        # any import of them now fails
    sys.path.insert(0, sys.argv[1])
    os.chdir(sys.argv[1])
    import main as cli
    from dstdgcn_tpu.utils.config import dump_yaml, load_yaml

    run = sys.argv[2]
    cfg = load_yaml(open("configs/dstdgcn_synthetic.yaml").read())
    cfg["model"]["dstdgcn"].update(num_feature=4, num_layers=1,
                                   input_time_frame=4, output_time_frame=4)
    for split in ("train", "test"):
        cfg["dataset"][split]["synthetic"].update(
            num_sequences=8, input_n=4, output_n=4)
    cfg["setting"].update(input_n=4, output_n=4, eval_frame=[1, 3])
    cfg.update(epoch=1, train_batch_size=8, test_batch_size=8)
    cfg["engine"]["max_iter"] = 1
    with open(os.path.join(run, "train.yaml"), "w") as f:
        f.write(dump_yaml(cfg))
    cli.main(["--run_dir", run, "--config", os.path.join(run, "train.yaml")])
    cfg["mode"] = "test"
    cfg["model"].update(load=True,
                        ckpt=os.path.join(run, "checkpoints", "best.ckpt"))
    with open(os.path.join(run, "test.yaml"), "w") as f:
        f.write(dump_yaml(cfg))
    cli.main(["--run_dir", run, "--config", os.path.join(run, "test.yaml")])
    train = open(os.path.join(run, "training_loss.csv")).read().splitlines()
    test = open(os.path.join(run, "testing_loss.csv")).read().splitlines()
    assert train[-1].split(",")[3] == test[1].split(",")[0], (train, test)
    assert all(sys.modules.get(n) is None for n in BLOCKED)
    print("MAIN_PATH_OK")
''')


def test_train_eval_checkpoint_without_optional_packages(tmp_path):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT, REPO, str(tmp_path)], env=env,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "MAIN_PATH_OK" in out.stdout
