"""The YAML-subset config loader (``configuration.load_yaml_subset``)."""

import os
import sys

import pytest

from shot_fpfh_tpu.configuration import load_config_from_yaml, load_yaml_subset

_DEFAULT = os.path.join(os.path.dirname(__file__), "..", "config", "default.yaml")


def _numeric_strings_as_floats(tree):
    """PyYAML follows YAML 1.1, where ``1e-3`` (no dot) is a string; the
    typed config recasts it to float either way."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            v = _numeric_strings_as_floats(v)
        elif isinstance(v, str):
            try:
                v = float(v)
            except ValueError:
                pass
        out[k] = v
    return out


def test_yaml_subset_matches_pyyaml_on_default_config():
    yaml = pytest.importorskip("yaml")
    with open(_DEFAULT) as f:
        text = f.read()
    ours = load_yaml_subset(text)
    assert ours == _numeric_strings_as_floats(yaml.safe_load(text))
    icp = ours["registration"]["icp"]
    assert icp["rms_threshold"] == 1e-3 and isinstance(icp["max_iter"], int)
    assert ours["registration"]["keypoint_selection"]["neighborhood_size"] is None
    assert ours["registration"]["descriptor"]["normalize"] is True


@pytest.mark.parametrize("text", [
    "a: [1, 2]",                 # flow sequence
    "a:\n  - 1",                 # block sequence
    "a: hello",                  # unquoted string
    "a: &x 1",                   # anchor
    "a: |\n  text",              # block scalar
    "a:\t1",                     # tab
    "a: 1\n  b: 2",              # indentation under a scalar
    "a: 1\na: 2",                # duplicate key
    "a: {b: 1}",                 # flow mapping
])
def test_yaml_subset_rejects_other_yaml(text):
    with pytest.raises(ValueError):
        load_yaml_subset(text)


def test_yaml_subset_nesting_comments_and_scalars():
    text = ("top:  # comment\n"
            "  empty:\n"
            "  s: 'x # not a comment'\n"
            "  d: \"y\"\n"
            "  inner:\n"
            "    f: -1.5e2\n"
            "    n: ~\n"
            "  after: 7\n"
            "other: false\n")
    assert load_yaml_subset(text) == {
        "top": {"empty": None, "s": "x # not a comment", "d": "y",
                "inner": {"f": -150.0, "n": None}, "after": 7},
        "other": False,
    }


def test_load_config_without_yaml_package(monkeypatch):
    """The CLI's config path needs no YAML package."""
    monkeypatch.setitem(sys.modules, "yaml", None)   # import yaml -> error
    cfg = load_config_from_yaml(_DEFAULT, {"radius": 1.25})
    assert cfg["descriptor"].radius == 1.25
    assert cfg["icp"].rms_threshold == 1e-3
    assert cfg["compute"].normals_k == 30
