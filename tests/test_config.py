"""The YAML-subset config reader/writer (utils/config.py)."""

import glob
import math
import os

import pytest

from dstdgcn_tpu.utils.config import (_resolve, dump_yaml, get_config,
                                      load_yaml, save_config)

CONFIGS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..",
                                        "configs", "*.yaml")))
IDS = [os.path.basename(p) for p in CONFIGS]


def test_shipped_config_count():
    assert len(CONFIGS) == 13


@pytest.mark.parametrize("path", CONFIGS, ids=IDS)
def test_reader_equals_yaml_safe_load(path):
    yaml = pytest.importorskip("yaml")
    with open(path) as f:
        src = f.read()
    assert load_yaml(src) == yaml.safe_load(src)


@pytest.mark.parametrize("path", CONFIGS, ids=IDS)
def test_save_then_load_round_trips(path, tmp_path):
    cfg = get_config(path)
    out = tmp_path / "saved.yaml"
    save_config(cfg, str(out), print_opts=False)
    assert get_config(str(out)).to_dict() == cfg.to_dict()


@pytest.mark.parametrize("text,want", [
    ("a: 3.e-3", {"a": 0.003}),
    ("a: 1e-3", {"a": "1e-3"}),          # YAML 1.1: no dot, no float
    ("a: True\nb: off\nc: None\nd: ~\ne: null", {
        "a": True, "b": False, "c": "None", "d": None, "e": None}),
    ("a: 'it''s' # note\nb: \"x # y\"", {"a": "it's", "b": "x # y"}),
    ("a: [1, [2, 3], {k: v}]", {"a": [1, [2, 3], {"k": "v"}]}),
    ("files:\n  [\n    a.py,\n    b.py,\n  ]\nn: 1",
     {"files": ["a.py", "b.py"], "n": 1}),
    ("a:\n- 1\n- x\nb:\n  c:\n    - 2", {"a": [1, "x"], "b": {"c": [2]}}),
    ("a:\nb: 2", {"a": None, "b": 2}),
    ("3dpw: {x: -1, y: +2, z: .5}", {"3dpw": {"x": -1, "y": 2, "z": 0.5}}),
])
def test_reader_scalars_and_collections(text, want):
    assert load_yaml(text) == want


@pytest.mark.parametrize("text", ["a: &x 1", "a: |\n  b", "a: [1, 2",
                                  "a: 1\na: 2", "a:\n  - k: v"])
def test_reader_rejects_unsupported_yaml(text):
    with pytest.raises(ValueError):
        load_yaml(text)


def test_writer_quotes_what_would_change_type():
    value = {"a": 1e-5, "b": "None", "c": "yes", "d": "012", "e": "",
             "f": "a: b", "g": [1.5, None, True, "x y"], "h": {}, "i": [],
             "j": "-x", "k": math.inf, "l": 7}
    text = dump_yaml(value)
    assert load_yaml(text) == value
    yaml = pytest.importorskip("yaml")
    assert yaml.safe_load(text) == value


def test_python_expressions_resolve():
    cfg = _resolve(load_yaml('d: "!!python sorted([3, 1, 2])"'))
    assert cfg == {"d": [1, 2, 3]}
