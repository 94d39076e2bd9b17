"""Where the program reads its platform: the detector's route and the
compile cache's directory."""

import os

import pytest

from feature_detector_fast_tpu import api
from feature_detector_fast_tpu.utils import cache

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))


@pytest.mark.parametrize("platform,route", [("gpu", "triton"),
                                            ("cpu", "xla")])
def test_detector_route(platform, route):
    assert api.detector_route(platform) == route


@pytest.mark.parametrize("platform", ["rocm", "metal", "neuron"])
def test_detector_route_refuses_other_platforms(platform):
    with pytest.raises(RuntimeError, match=platform):
        api.detector_route(platform)


def test_default_route_follows_the_backend():
    assert api.detector_route() == "xla"  # the tests run on the CPU
    assert api.effective_width(200) == 200


def test_cache_dir_defaults_inside_the_checkout(monkeypatch):
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    gpu_dir = cache.cache_dir("gpu")
    assert gpu_dir == os.path.join(REPO, ".xla_cache", "gpu")
    cpu_dir = cache.cache_dir("cpu")
    assert os.path.dirname(cpu_dir) == os.path.join(REPO, ".xla_cache")
    assert cache.cache_dir("cpu") == cpu_dir  # fixed: same path every call
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".xla_cache/" in f.read().split()


def test_cache_dir_env_var_wins(monkeypatch):
    monkeypatch.setenv(cache.ENV_VAR, "/elsewhere/cache")
    assert cache.cache_dir("gpu") is None
    assert cache.cache_dir("cpu") is None
