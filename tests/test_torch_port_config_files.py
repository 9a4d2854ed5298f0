"""The port's experiment files (``visinger_tpu_torch/config_loader.py``)
against the JAX package's: its YAML reader against PyYAML's ``safe_load``
(tests may import PyYAML; the port may not), its copies of the JAX
defaults, the ``base_config`` chains of ``configs/*.yaml`` against JAX's
``load_config``, the constructs it refuses, and ``run --config`` with a
YAML file.  Exact comparisons: a config is data."""

import argparse
import dataclasses
import json
import math
import shutil
from pathlib import Path

import pytest
import yaml

from visinger_tpu.config import load_config as j_load_config
from visinger_tpu_torch import config as port_config
from visinger_tpu_torch import run
from visinger_tpu_torch.config_loader import (DEFAULTS_DIR, load_config,
                                              parse_yaml, read_yaml)

import test_torch_port_cores  # noqa: F401  (shares the cores)
from test_torch_port_modules import _JAX_CODE_DEFAULTS, _as_tuples

REPO = Path(__file__).resolve().parents[1]
JAX_DEFAULTS = REPO / "visinger_tpu" / "config" / "defaults"
EXPERIMENTS = sorted(p.name for p in (REPO / "configs").glob("*.yaml"))
YAML_FILES = ([f"configs/{n}" for n in EXPERIMENTS]
              + [f"visinger_tpu/config/defaults/{p.name}"
                 for p in sorted(JAX_DEFAULTS.glob("*.yaml"))])


def typed(v):
    """``v`` with every scalar paired with its type, so that 1, 1.0 and
    True differ; NaN as its repr."""
    if isinstance(v, dict):
        return {typed(k): typed(x) for k, x in v.items()}
    if isinstance(v, list):
        return [typed(x) for x in v]
    if isinstance(v, float) and math.isnan(v):
        return ("float", "nan")
    return (type(v).__name__, v)


@pytest.mark.parametrize("rel", YAML_FILES)
def test_reader_equals_safe_load_on_the_repos_files(rel):
    with open(REPO / rel) as f:
        want = yaml.safe_load(f)
    assert typed(read_yaml(str(REPO / rel))) == typed(want)


SCALARS = ["1e-9", "1.0e-9", "1.0e9", "6.8e+3", "yes", "No", "ON", "off",
           "True", "~", "null", "NULL", "''", "'1'", '"a\\tb\\u00e9"',
           "'it''s'", "it's", "0x1F", "010", "0b101", "-0", "+12", "1_000",
           "1:30", "1:30.5", ".5", "1.", "-.inf", ".nan", "y", "n",
           "x#y", "[[1, 2], [3, [4, 'x']], \"y\"]", "[1, 2, ]", "[]",
           "[yes, ~, 1.0e-3, a b]", "b # c"]


@pytest.mark.parametrize("text", SCALARS)
def test_reader_resolves_scalars_as_safe_load(text):
    doc = f"a: {text}\nb:\n  - {text}\n"
    assert typed(parse_yaml(doc)) == typed(yaml.safe_load(doc))


def test_reader_block_forms_equal_safe_load():
    doc = ("# a comment\n---\nlist:\n- 1\n- k: v\n  j: [2]\n-\n  - x\n"
           "nested:\n  inner:\n    deep: 'q'  # trailing\n  empty:\n"
           "'quoted key': \"v\"\nlast: end\n")
    assert typed(parse_yaml(doc)) == typed(yaml.safe_load(doc))
    assert parse_yaml("") is None and parse_yaml("# only\n") is None


@pytest.mark.parametrize("name", ["base", "visinger", "csd",
                                  "visinger_csd"])
def test_defaults_are_byte_copies(name):
    assert (DEFAULTS_DIR / f"{name}.yaml").read_bytes() == (
        JAX_DEFAULTS / f"{name}.yaml").read_bytes()


@pytest.mark.parametrize("name", EXPERIMENTS)
def test_experiment_files_match_jax_and_the_recipes(name):
    """Each ``configs/*.yaml`` through the port's chain equals JAX's
    ``load_config`` of it on every field the port has (for the keys the
    chain leaves out, the default the JAX code reads them with), and the
    port's recipe of that name; ``run --config`` takes the file."""
    path = str(REPO / "configs" / name)
    cfg, ref = load_config(path), j_load_config(path)
    for f in dataclasses.fields(cfg):
        want = ref.get(f.name, _JAX_CODE_DEFAULTS.get(f.name, KeyError))
        assert _as_tuples(getattr(cfg, f.name)) == _as_tuples(want), f.name
    recipe = port_config.RECIPES[name[:-len(".yaml")]]()
    assert cfg == recipe
    assert run.load_config_arg(path) == recipe


def test_chain_resolves_without_the_jax_package(tmp_path, monkeypatch):
    """In a tree with no ``visinger_tpu/``: a file of the JAX defaults
    resolves to the port's copy, relative bases to the including file, a
    string base as a one-element list, later bases and the file winning,
    and a cycle stops at a file already read."""
    (tmp_path / "configs").mkdir()
    shutil.copy(REPO / "configs" / "tpu_run.yaml", tmp_path / "configs")
    (tmp_path / "exp").mkdir()
    (tmp_path / "exp" / "a.yaml").write_text(
        "base_config:\n  - ../configs/tpu_run.yaml\n  - ./b.yaml\n"
        "hidden_size: 20\nbinarization_args:\n  min_text: 3\n")
    (tmp_path / "exp" / "b.yaml").write_text(
        "base_config: ./a.yaml\nnum_heads: 4\nhidden_size: 32\n"
        "max_updates: 7\n")
    monkeypatch.chdir(tmp_path)
    assert not (tmp_path / "visinger_tpu").exists()
    cfg = load_config("exp/a.yaml")
    want = port_config.tpu_run()
    want = want.replace(
        hidden_size=20, num_heads=4, max_updates=7,
        binarization_args=port_config.Args(want.binarization_args,
                                           min_text=3))
    assert cfg == want
    # overrides last, dotted keys into the argument dicts
    assert load_config("exp/b.yaml", "binarization_args.min_text=9"
                       ).binarization_args.min_text == 9


BAD = [("a: 1\nb: &x 2\n", 2, "anchors"),
       ("a: 1\nb: *x\n", 2, "aliases"),
       ("a: !!str 1\n", 1, "tags"),
       ("a: 1\nb: |\n  text\n", 2, "literal blocks"),
       ("b: >\n  text\n", 1, "folded blocks"),
       ("a: {b: 1}\n", 1, "flow mappings"),
       ("a: 1\n---\nb: 2\n", 2, "several documents"),
       ("%YAML 1.1\na: 1\n", 1, "directives"),
       ("a: [1,\n  2]\n", 1, "several lines"),
       ("a: 'x\n  y'\n", 1, "several lines"),
       ("a: 2001-12-14\n", 1, "timestamps"),
       ("<<: 1\n", 1, "merge keys"),
       ("? a\n: b\n", 1, "complex keys"),
       ("a: b\n  c\n", 2, "indentation"),
       ("a:\n\t- 1\n", 2, "tab")]


@pytest.mark.parametrize("text,line,what", BAD)
def test_reader_refuses_with_file_and_line(text, line, what, tmp_path):
    path = tmp_path / "bad.yaml"
    path.write_text(text)
    with pytest.raises(ValueError, match=f"bad.yaml:{line}: .*{what}"):
        read_yaml(str(path))


def _args(**kw):
    base = dict(config="", hparams="", debug=False, exp_name="",
                remove=False, reset=False)
    return argparse.Namespace(**{**base, **kw})


def test_run_config_yaml_persists_and_drops_the_unread_keys(tmp_path,
                                                            monkeypatch):
    """``--config`` a YAML file: the merged config is written as
    ``config.json``; the JAX package's TPU-only keys are taken and dropped
    in ``--hparams`` and in a file, any other unknown key raises."""
    monkeypatch.chdir(tmp_path)
    exp = tmp_path / "exp.yaml"
    exp.write_text(f"base_config: {REPO / 'configs' / 'soak_r5.yaml'}\n"
                   "work_dir: ckpt/x\nattn_impl: legacy\n"
                   "decoder_polyphase: true\n")
    cfg = run.resolve_config(_args(config=str(exp),
                                   hparams="attn_impl=pallas,use_pallas=true"))
    assert cfg == port_config.soak_r5().replace(work_dir="ckpt/x")
    saved = json.loads((tmp_path / "ckpt" / "x" / "config.json").read_text())
    assert port_config.Config.from_dict(saved) == cfg
    assert not set(saved) & port_config.UNREAD_KEYS
    with pytest.raises(KeyError, match="no_such_key"):
        run.resolve_config(_args(config=str(exp), hparams="no_such_key=1"),
                           persist=False)
    exp.write_text(f"base_config: {REPO / 'configs' / 'tpu_run.yaml'}\n"
                   "flow_wn_dilation_rate: 2\n")
    with pytest.raises(KeyError, match="flow_wn_dilation_rate"):
        run.resolve_config(_args(config=str(exp)), persist=False)
