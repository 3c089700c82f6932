"""The port's config (dvmvs_tpu_torch/config.py) against the JAX package's:
the same dataclasses, field by field and default by default, the same
derived properties and the same constants."""

import dataclasses
import inspect

import pytest

from dvmvs_tpu import config as jconfig
from dvmvs_tpu_torch import config as tconfig


def _dataclasses(module):
    return sorted(name for name, obj in vars(module).items()
                  if inspect.isclass(obj) and dataclasses.is_dataclass(obj)
                  and obj.__module__ == module.__name__)


def test_same_dataclasses():
    assert _dataclasses(tconfig) == _dataclasses(jconfig) == \
        ["DepthConfig", "PathsConfig", "TestConfig", "TrainConfig"]


@pytest.mark.parametrize("name", _dataclasses(jconfig))
def test_dataclass_matches_jax(name):
    want, got = getattr(jconfig, name), getattr(tconfig, name)
    assert got.__dataclass_params__.frozen == want.__dataclass_params__.frozen
    want_fields, got_fields = dataclasses.fields(want), dataclasses.fields(got)
    assert [f.name for f in got_fields] == [f.name for f in want_fields]
    for g, w in zip(got_fields, want_fields):
        assert g.type == w.type, g.name
        assert g.default_factory is w.default_factory is dataclasses.MISSING, g.name
        if dataclasses.is_dataclass(w.default):  # a nested config: compare its values
            assert dataclasses.asdict(g.default) == dataclasses.asdict(w.default), g.name
        else:
            assert g.default == w.default and type(g.default) is type(w.default), g.name
    assert dataclasses.asdict(got()) == dataclasses.asdict(want())
    properties = sorted(k for k, v in vars(want).items() if isinstance(v, property))
    assert properties == sorted(k for k, v in vars(got).items() if isinstance(v, property))
    for prop in properties:
        assert getattr(got(), prop) == getattr(want(), prop), prop


@pytest.mark.parametrize("levels", [2, 16, 64])
def test_depth_properties_match_jax(levels):
    want = jconfig.DepthConfig(0.5, 10.0, levels)
    got = tconfig.DepthConfig(0.5, 10.0, levels)
    for prop in ("inverse_depth_base", "inverse_depth_multiplier", "inverse_depth_step"):
        assert getattr(got, prop) == getattr(want, prop)


def test_constants_match_jax():
    for name in ("SCALE_RGB", "MEAN_RGB", "STD_RGB"):
        assert getattr(tconfig, name) == getattr(jconfig, name), name
    assert dataclasses.asdict(tconfig.DEFAULT_TRAIN) == dataclasses.asdict(jconfig.DEFAULT_TRAIN)
    assert dataclasses.asdict(tconfig.DEFAULT_TEST) == dataclasses.asdict(jconfig.DEFAULT_TEST)
