"""The port's YAML reader (`ldt_torch.tools.io.load_yaml`) against
`yaml.safe_load`: every YAML file the repository ships, the YAML 1.1
scalar resolution it must reproduce, and the syntax it refuses."""

import math
from pathlib import Path

import pytest
import yaml

from ldt_torch.tools.io import load_yaml

ROOT = Path(__file__).resolve().parents[1]


def _shipped():
    paths = list(ROOT.glob("experiments/**/*.yaml")) + [
        ROOT / "test" / "val_config.yaml"]
    return sorted(str(p.relative_to(ROOT)) for p in paths)


def test_the_repository_ships_25_yaml_files():
    """24 experiments/**/config.yaml and test/val_config.yaml."""
    files = _shipped()
    assert len(files) == 25, files
    assert "test/val_config.yaml" in files
    assert sum(f.startswith("experiments/") for f in files) == 24


@pytest.mark.parametrize("name", _shipped())
def test_shipped_file_reads_as_safe_load(name):
    path = ROOT / name
    with open(path) as f:
        want = yaml.safe_load(f)
    assert load_yaml(str(path)) == want


def _both(tmp_path, text):
    path = tmp_path / "c.yaml"
    path.write_text(text)
    with open(path) as f:
        return load_yaml(str(path)), yaml.safe_load(f)


# YAML 1.1 as PyYAML resolves it: a float needs a dot ('1e-5' is a string),
# yes/no/on/off are bools, 0-prefixed digits octal, ':'-separated base 60
@pytest.mark.parametrize("scalar", [
    "1e-5", "1.0e-05", "-30", "0.0", "~", "null", "Null", "", "'{:.4f}'",
    "null  # enter your checkpoint", "0.0001  # trailing", "true", "False",
    "yes", "off", "On", "tRue", "017", "08", "0x1F", "0b101", "0o17",
    "1_000", "+1", "1.", ".5", "-.inf", ".NaN", "1:30", "1:30.5",
    "'it''s'", '"a b"', "a#b", "a #b", "layer_norm", "1-NN-CD-acc_t",
    "data/ShapeNetCore.v2.PC15k", "ldt_tpu.models.score", "-1", "''"])
def test_scalar_resolves_as_safe_load(tmp_path, scalar):
    got, want = _both(tmp_path, f"a:\n  k: {scalar}\n  z: 1\n")
    g, w = got["a"]["k"], want["a"]["k"]
    if isinstance(w, float) and math.isnan(w):
        assert isinstance(g, float) and math.isnan(g)
    else:
        assert g == w and type(g) is type(w), (g, w)
    assert got["a"]["z"] == 1


@pytest.mark.parametrize("text", [
    "# a comment\nk:   # trailing\n  - x  # c\n  - 'y'\nm:\n- 1\n- 2.5\n"
    "n: ~\n",
    "a:\n  b:\n    c: 1\n  d: 2\ne: x\n",
    "",
])
def test_structures_read_as_safe_load(tmp_path, text):
    got, want = _both(tmp_path, text)
    assert got == want


@pytest.mark.parametrize("text,what", [
    ("k: [1, 2]\n", "unsupported syntax"),
    ("k: {a: 1}\n", "unsupported syntax"),
    ("k: &x 1\nj: *x\n", "unsupported syntax"),
    ("k: !!str 1\n", "unsupported syntax"),
    ("k: |\n  text\n", "unsupported syntax"),
    ("k: >\n  text\n", "unsupported syntax"),
    ("k: a\n  b\n", "multi-line"),
    ("k: 'a\n  b'\n", "multi-line"),
    ("---\nk: 1\n", "document markers"),
    ("k: 2001-12-14\n", "timestamp"),
    ("<<: 1\n", "merge"),
    ("k: 1\nk: 2\n", "duplicate key"),
    ("k:\n\t- 1\n", "tab"),
    ("- - 1\n", "only scalars"),
    ("- a: 1\n", "mapping inside"),
    ("k: a: b\n", "mapping inside"),
    ("k:v\n", "expected 'key: value'"),
    ("k: \"a\\nb\"\n", "escapes"),
    ("a:\n    b: 1\n  c: 2\n", "unexpected indentation"),
])
def test_unsupported_syntax_raises_with_its_line(tmp_path, text, what):
    path = tmp_path / "bad.yaml"
    path.write_text(text)
    with pytest.raises(ValueError, match=what) as err:
        load_yaml(str(path))
    assert "line " in str(err.value) and str(path) in str(err.value)
