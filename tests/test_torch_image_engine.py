"""The port's C++ image engine and load_and_resize against the JAX package's:
the engines bit for bit on one machine, load_and_resize with the engine on
(both packages' default) and off (PIL)."""

import numpy as np
import pytest

from mafed_tpu.core.config import VisionConfig as JVisionConfig
from mafed_tpu.data import images as jimages
from mafed_tpu.native import engine as jengine

from mafed_tpu_torch.core.config import VisionConfig
from mafed_tpu_torch.data import images as timages
from mafed_tpu_torch.native import engine as tengine

from PIL import Image


@pytest.fixture(scope="module")
def engines():
    """(port engine, JAX engine): both build here (g++, libjpeg and libpng)."""
    port, jax_side = tengine.get_engine(), jengine.get_engine()
    assert port is not None, tengine.failure()
    assert jax_side is not None, "the JAX package's engine did not build"
    return port, jax_side


@pytest.fixture(scope="module")
def sample_images(tmp_path_factory):
    """tests/test_native_engine.py's images: smooth (JPEG), noise (PNG), tall (JPEG)."""
    root = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:300, 0:400]
    smooth = np.stack([x % 251, y % 251, (x + y) % 251], -1).astype(np.uint8)
    noisy = rng.integers(0, 256, size=(257, 311, 3), dtype=np.uint8)
    paths = {}
    for name, arr, fmt in [("smooth", smooth, "jpg"), ("noisy", noisy, "png"), ("tall", smooth.transpose(1, 0, 2), "jpg")]:
        p = str(root / f"{name}.{fmt}")
        if fmt == "jpg":
            Image.fromarray(arr).save(p, quality=95)
        else:
            Image.fromarray(arr).save(p)
        paths[name] = p
    return paths


@pytest.mark.parametrize("name", ["smooth", "noisy", "tall"])
@pytest.mark.parametrize("img_size", [224, 336])
def test_engine_bit_equal_to_jax(engines, sample_images, name, img_size):
    port, jax_side = engines
    got = port.decode(sample_images[name], img_size, 0.9)
    want = jax_side.decode(sample_images[name], img_size, 0.9)
    assert got.dtype == np.uint8 and got.shape == (img_size, img_size, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("native", ["1", "0"], ids=["engine", "pil"])
def test_load_and_resize_matches_jax(engines, sample_images, monkeypatch, native):
    """Both packages at their defaults (use_native=True) under MAFED_NATIVE_IMAGES."""
    monkeypatch.setenv("MAFED_NATIVE_IMAGES", native)
    for path in sample_images.values():
        got = timages.load_and_resize(path, VisionConfig())
        np.testing.assert_array_equal(got, jimages.load_and_resize(path, JVisionConfig()))
        if native == "1":
            np.testing.assert_array_equal(got, engines[0].decode(path, 224, 0.9))


def test_env_zero_and_use_native_false_give_pil(engines, sample_images, monkeypatch):
    path = sample_images["noisy"]
    pil = jimages.load_and_resize(path, JVisionConfig(), use_native=False)
    np.testing.assert_array_equal(timages.load_and_resize(path, VisionConfig(), use_native=False), pil)
    monkeypatch.setenv("MAFED_NATIVE_IMAGES", "0")
    np.testing.assert_array_equal(timages.load_and_resize(path, VisionConfig()), pil)
    # the engine differs from PIL on noise (it keeps doubles between its passes): the switch is real
    assert not np.array_equal(engines[0].decode(path, 224, 0.9), pil)


def test_missing_file_raises_ioerror(engines, tmp_path):
    missing = str(tmp_path / "nonexistent.jpg")
    with pytest.raises(IOError):
        engines[0].decode(missing, 224)
    with pytest.raises(IOError):
        timages.load_and_resize(missing, VisionConfig())


def test_library_lands_under_the_port_build_dir(engines):
    port = engines[0]
    assert port.path == tengine.library_path()
    assert port.path.parent == tengine.BUILD_DIR and port.path.parent.name == "_build"
    assert port.path.parent.parent.name == "mafed_tpu_torch" and port.path.exists()
    assert tengine.native_available() and tengine.failure() is None
