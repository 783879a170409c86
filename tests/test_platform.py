"""Device, compile-cache and optional-import rules (CPU)."""

import os
import sys
from types import SimpleNamespace

import pytest

import bundlefusion_tpu
from bundlefusion_tpu.utils.device import device_summary, require_gpu


def test_require_gpu_raises_on_cpu():
    with pytest.raises(RuntimeError, match="no CPU fallback"):
        require_gpu()


@pytest.mark.parametrize("platform", ["cpu", "tpu"])
def test_require_gpu_rejects_other_platforms(platform):
    fake = [SimpleNamespace(platform=platform, device_kind="x")]
    with pytest.raises(RuntimeError):
        require_gpu(fake)


def test_require_gpu_accepts_gpus():
    fake = [SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")] * 4
    assert require_gpu(fake) is fake
    assert device_summary(fake) == {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4,
    }


def test_chip_smoke_fails_without_gpu(capsys):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    with pytest.raises(RuntimeError):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_compile_cache_dir_from_environment():
    assert bundlefusion_tpu.compile_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": "/somewhere/cc"}
    ) == "/somewhere/cc"


@pytest.mark.parametrize("environ", [{}, {"JAX_COMPILATION_CACHE_DIR": ""}])
def test_compile_cache_dir_default_is_in_checkout(environ):
    root = os.path.dirname(os.path.dirname(os.path.abspath(bundlefusion_tpu.__file__)))
    assert bundlefusion_tpu.compile_cache_dir(environ) == os.path.join(root, ".jax_cache")
    # fixed: no process id, time or temporary name in it
    assert bundlefusion_tpu.compile_cache_dir(environ) == bundlefusion_tpu.compile_cache_dir({})


def test_missing_cv2_names_it(monkeypatch):
    from bundlefusion_tpu.io import require_cv2

    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 -> ImportError
    with pytest.raises(ImportError, match="cv2"):
        require_cv2()
