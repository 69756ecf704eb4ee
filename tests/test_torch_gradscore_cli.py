"""The port's gradientScores command as a whole.

The JAX package's colorDepthSearch runs once; then the JAX and the port
gradientScores (``--device cpu``: the kernels' plain versions) rescore
copies of its result tree, and every per-mask file must be
byte-identical. The device-resident store and the float64 oracle
(``--no-use-device``) must also write what the default path writes.
"""

import shutil

import numpy as np
import pytest
import torch

from colormipsearch_tpu.cli import main as jax_main
from colormipsearch_tpu_torch import testing
from colormipsearch_tpu_torch.cli import main as torch_main
from colormipsearch_tpu_torch.dataio.json_io import write_neurons_json
from colormipsearch_tpu_torch.model import ComputeFileType

torch.set_num_threads(2)
H, W = 48, 72
CDS_FLAGS = ["--maskThreshold", "20", "--dataThreshold", "20",
             "--pixColorFluctuation", "1.0", "--xyShift", "2",
             "--no-name-labels", "--no-colormap-labels",
             "--pctPositivePixels", "0", "--cdsConcurrency", "2"]
GS_FLAGS = ["--maskThreshold", "20", "--no-name-labels",
            "--no-colormap-labels", "--negativeRadius", "4",
            "--processing-tag", "gs1", "--cdsConcurrency", "2"]


def _tree(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*.json")) if p.is_file()}


def _gradient_scores(main, tree, *flags, device=True):
    argv = ["gradientScores", "--matches", str(tree / "masks"),
            "-od", str(tree), "--perMaskSubdir", "masks", *GS_FLAGS,
            *flags]
    if device:
        argv += ["--device", "cpu"]
    assert main(argv) == 0


@pytest.fixture(scope="module")
def cds_run(tmp_path_factory):
    """colorDepthSearch results (JAX CLI) over 6 masks x 12 targets with
    gradient and z-gap variants (one target without a z-gap: the
    dilation fallback), a query ROI mask, and the port's default
    gradientScores tree."""
    tmp = tmp_path_factory.mktemp("gs")
    rng = np.random.default_rng(23)
    lib = testing.synthetic_library(rng, 12, 5, H, W, target_fg=0.08,
                                    mask_fg=0.03)
    corner = np.zeros_like(lib.targets[3])
    corner[-14:, -18:] = lib.targets[3][-14:, -18:]
    lib.masks.append(corner)  # a query with a wide high-expression ring
    targets = testing.write_neuron_images(
        tmp / "lib", lib.targets, "t",
        gradients=[testing.synthetic_gradient(rng, t) for t in lib.targets],
        zgaps=[testing.synthetic_zgap(t, radius=4) for t in lib.targets],
        threads=2)
    targets[5].compute_files.pop(ComputeFileType.ZGapImage)
    masks = testing.write_neuron_images(tmp / "lib", lib.masks, "m",
                                        threads=2)
    write_neurons_json(targets, tmp / "targets.json")
    write_neurons_json(masks, tmp / "masks.json")
    testing.write_png(tmp / "roi.png",
                      testing.scattered_pixels(rng, H, W, 2500))
    assert jax_main.main(["colorDepthSearch", "-m", str(tmp / "masks.json"),
                          "-i", str(tmp / "targets.json"), "-od",
                          str(tmp / "cds"), "--perMaskSubdir", "masks",
                          "--mirrorMask", *CDS_FLAGS]) == 0
    default = tmp / "port_default"
    shutil.copytree(tmp / "cds", default)
    _gradient_scores(torch_main.main, default, "--mirrorMask")
    return tmp, _tree(default)


@pytest.mark.parametrize("case", ["default", "device_store", "oracle",
                                  "no_mirror", "roi"])
def test_result_files_identical_to_jax(cds_run, tmp_path, monkeypatch,
                                       case):
    tmp, port_default = cds_run
    flags = [] if case == "no_mirror" else ["--mirrorMask"]
    if case == "oracle":
        flags.append("--no-use-device")
    if case == "roi":
        flags += ["--query-roi-mask", str(tmp / "roi.png")]
    runs = 1
    if case == "device_store":
        # the first run builds each package's store, the second scores
        # every target from the device-resident fields
        monkeypatch.setenv("CDS_SHAPE_STORE_DEVICE", "1")
        runs = 2
    trees = {}
    for name, main, device in (("port", torch_main.main, True),
                               ("jax", jax_main.main, False)):
        root = tmp_path / name
        shutil.copytree(tmp / "cds", root)
        extra = ["--packed-variants-store", str(tmp_path / f"{name}_store")] \
            if case == "device_store" else []
        for _ in range(runs):
            _gradient_scores(main, root, *flags, *extra, device=device)
        trees[name] = _tree(root)
    port, ref = trees["port"], trees["jax"]
    assert sum(k.startswith("masks/") for k in port) >= 3
    assert port.keys() == ref.keys()
    for name in port:
        assert port[name] == ref[name], name
    assert any(b'"gradientAreaGap"' in doc for doc in port.values())
    if case in ("default", "device_store", "oracle"):
        assert port == port_default


def test_device_cuda_without_gpu_and_db_storage_raise(cds_run, tmp_path):
    """--device cuda without a GPU raises. (The DB storage no longer
    raises: test_torch_cli.py test_db_storage_completes_and_equals_jax
    runs it against the JAX CLI.)"""
    tmp, _ = cds_run
    root = tmp_path / "o"
    shutil.copytree(tmp / "cds", root)
    argv = ["gradientScores", "--matches", str(root / "masks"), "-od",
            str(root), *GS_FLAGS]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            torch_main.main(argv + ["--device", "cuda"])


def test_variant_writers_and_gray16_png_reader(tmp_path, monkeypatch):
    """The synthetic variants are what they claim, and a 16-bit gray PNG
    decodes on a host with neither PIL nor the native library."""
    from scipy import ndimage

    from colormipsearch_tpu.io.image import read_image as jax_read_image
    from colormipsearch_tpu_torch.io import image as timage
    from colormipsearch_tpu_torch.io import native_decoder

    rng = np.random.default_rng(4)
    cdm = testing.synthetic_cdm(rng, 37, 53, fg_fraction=0.1)
    fg = (cdm > 20).any(axis=-1)
    grad = testing.synthetic_gradient(rng, cdm)
    assert grad.dtype == np.uint16 and grad.max() < 400
    assert not grad[fg].any() and grad[~fg].any()
    masked = np.where(fg[..., None], cdm, 0).astype(np.uint8)
    for radius in (0, 1, 4, 20):
        np.testing.assert_array_equal(
            testing.synthetic_zgap(cdm, radius=radius),
            ndimage.maximum_filter(masked, size=(2 * radius + 1,
                                                 2 * radius + 1, 1),
                                   mode="constant", cval=0))
    grad[0, :3] = (0xFFFF, 256, 1)
    data = testing.encode_png_gray16(grad)
    np.testing.assert_array_equal(timage.decode_png_gray16(data), grad)
    np.testing.assert_array_equal(jax_read_image(data).pixels, grad)
    monkeypatch.setattr(native_decoder, "decode_img", lambda data: None)
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    monkeypatch.setitem(__import__("sys").modules, "PIL.Image", None)
    img = timage.read_image(data)
    assert img.type is timage.ImageType.GRAY16
    np.testing.assert_array_equal(img.pixels, grad)
    rgb = timage.read_image(testing.encode_png(cdm))
    assert rgb.type is timage.ImageType.RGB
    np.testing.assert_array_equal(rgb.pixels, cdm)
    with pytest.raises(ValueError):
        timage.decode_png_gray16(testing.encode_png(cdm))
    with pytest.raises(ValueError):
        timage.decode_png_rgb8(data)
