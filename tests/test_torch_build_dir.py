"""Where the port builds its native libraries (`topo_renderer_tpu_torch.build_dir`).

In a checkout (the package's parent holds ``pyproject.toml``) the CUDA
kernels of `cuda_build.py` and `native/`'s host library build into
``build/topo_renderer_tpu_torch/`` at its root; elsewhere, as in a
non-editable install under site-packages, into the per-user cache. A kernel
build directory that cannot be created raises a RuntimeError naming it
before nvcc runs.
"""

from pathlib import Path

import pytest

import topo_renderer_tpu_torch
from topo_renderer_tpu_torch import build_dir, cuda_build, native

REPO = Path(__file__).resolve().parent.parent


def test_checkout_builds_at_its_root():
    assert (REPO / "pyproject.toml").is_file()
    assert topo_renderer_tpu_torch.PACKAGE_DIR == REPO / "topo_renderer_tpu_torch"
    assert build_dir() == REPO / "build" / "topo_renderer_tpu_torch"


@pytest.mark.parametrize("xdg", ["set", "unset", "relative"])
def test_installed_package_builds_in_the_user_cache(monkeypatch, tmp_path, xdg):
    site = tmp_path / "site-packages"
    pkg = site / "topo_renderer_tpu_torch"
    pkg.mkdir(parents=True)
    (site / "setup.cfg").write_text("")  # not a checkout: no pyproject.toml beside the package
    home = tmp_path / "home"
    monkeypatch.setenv("HOME", str(home))
    if xdg == "set":
        monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
        want = tmp_path / "xdg" / "topo_renderer_tpu_torch"
    else:
        # The XDG spec ignores a relative XDG_CACHE_HOME.
        if xdg == "relative":
            monkeypatch.setenv("XDG_CACHE_HOME", "relative/cache")
        else:
            monkeypatch.delenv("XDG_CACHE_HOME", raising=False)
        want = home / ".cache" / "topo_renderer_tpu_torch"
    assert build_dir(pkg) == want
    assert not want.exists()  # naming the directory builds nothing


def test_both_builders_use_it(monkeypatch, tmp_path):
    assert cuda_build._lib_path("crossing").parent == build_dir()
    assert native.lib_path().parent == build_dir()
    for module in (cuda_build, native):
        monkeypatch.setattr(module, "build_dir", lambda: tmp_path / "elsewhere")
    assert cuda_build._lib_path("window_slice").parent == tmp_path / "elsewhere"
    assert native.lib_path().parent == tmp_path / "elsewhere"


@pytest.mark.parametrize("entry", ["build_all", "load"])
def test_kernel_build_dir_that_cannot_be_made_raises(monkeypatch, tmp_path, entry):
    blocker = tmp_path / "blocker"
    blocker.write_text("")  # a file where a directory must go: mkdir fails, even as root
    bad = blocker / "topo_renderer_tpu_torch"
    monkeypatch.setattr(cuda_build, "build_dir", lambda: bad)
    nvcc_calls = []

    def no_nvcc(*args, **kw):
        nvcc_calls.append(args)
        raise AssertionError("nvcc must not run")

    monkeypatch.setattr(cuda_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(cuda_build.subprocess, "Popen", no_nvcc)
    with pytest.raises(RuntimeError, match="kernel build directory") as err:
        if entry == "build_all":
            cuda_build.build_all()
        else:
            cuda_build.load("crossing")
    assert str(bad) in str(err.value)
    assert not nvcc_calls and "crossing" not in cuda_build._libs


def test_native_falls_back_where_it_cannot_build(monkeypatch, tmp_path):
    """`native.available()` keeps JAX's meaning: False where the library
    cannot be built, and the Python decoder runs."""
    blocker = tmp_path / "blocker"
    blocker.write_text("")
    monkeypatch.setattr(native, "build_dir", lambda: blocker / "topo_renderer_tpu_torch")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.delenv("TOPO_DISABLE_NATIVE", raising=False)
    assert not native.available()
