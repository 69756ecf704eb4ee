"""The port's input commands and their lookups against the JAX package.

createColorDepthSearchDataInput (v3 neuron JSON) and
createColorDepthSearchJSONInput (v2 MIP lists) write byte-identical
files in both packages from the same library, as a directory and as a
zip: the gradient and z-gap variant lookup (nested, same-basename
collisions, the contains-stem fallback, variants in a zip),
--segmented-mips (EM neuron states; LM channels and objectives), --type,
--for-update, the neuron filters and --tag. find_variant and
lookup_searchable_images hold the JAX functions' results over one table
of cases each. No command here runs the device.
"""

import zipfile

import numpy as np
import pytest

from colormipsearch_tpu.cli import main as jax_main
from colormipsearch_tpu.io import mips as jax_mips
from colormipsearch_tpu.io import naming as jax_naming
from colormipsearch_tpu import model as jax_model
from colormipsearch_tpu_torch import model as torch_model
from colormipsearch_tpu_torch import testing
from colormipsearch_tpu_torch.cli import main as torch_main
from colormipsearch_tpu_torch.io import mips as torch_mips
from colormipsearch_tpu_torch.io import naming as torch_naming

PNG = testing.encode_png(np.zeros((4, 6, 3), np.uint8))
LM = ["sc1-line_40x_ch2_CDM.png", "sc2-line_20x_ch1_CDM.png",
      "sc3-line_CDM.png", "sc4-line_ch1_CDM.png"]
EM = ["12345-LV_18U.png", "23456-TC_18U.png", "34567_18U.png"]
FILES = [
    *(f"lm/{n}" for n in LM), *(f"em/{n}" for n in EM),
    # exact candidates, one of them under two parents (the collision
    # resolves to the MIP's parent directory, "lm")
    "grad/lm/sc1-line_40x_ch2_CDM_gradient.png",
    "grad/other/sc1-line_40x_ch2_CDM_gradient.png",
    "grad/deep/er/sc4-line_ch1_CDM_gradient.png",
    # the contains-stem fallback (no exact candidate)
    "grad/pre-sc2-line_20x_ch1_CDM_gradient-x.png",
    # only with --librarySuffix _CDM stripped (the cdm_suffix case)
    "grad/sc3-line_gradient.png",
    "zgap/sc1-line_40x_ch2_CDM_20pxRGB.png",
    "zgap/sc2-line_20x_ch1_CDM_20pxRGB.tif",
    # a name with the stem but not the suffix must not match
    "zgap/sc4-line_ch1_CDM_other.png",
    # LM segmentations: channel and objective filters
    "seg/sc1-line_40x_ch2_01.png", "seg/sc1-line_40x_ch1_01.png",
    "seg/sc1-line_20x_ch2_01.png", "seg/sc1-line_ch2_02.png",
    "seg/sc2-line_ch1_01.png",
    # EM segmentations: neuron states
    "emseg/12345-LV_18U_FL.png", "emseg/12345-TC_18U_FL.png",
    "emseg/23456-TC_18U_01.png", "emseg/34567_18U_01.png",
]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """The library as files, and lib.zip (the LM MIPs) and grads.zip (the
    gradients, under other directories) beside it."""
    root = tmp_path_factory.mktemp("inputs")
    for name in FILES:
        (root / name).parent.mkdir(parents=True, exist_ok=True)
        (root / name).write_bytes(PNG)
    with zipfile.ZipFile(root / "lib.zip", "w") as z:
        for n in LM:
            z.writestr(f"lib/{n}", PNG)
    with zipfile.ZipFile(root / "grads.zip", "w") as z:
        for name in FILES:
            if name.startswith("grad/"):
                z.writestr("g/" + name[len("grad/"):], PNG)
    return root


def _clear_caches():
    """Each package indexes a variant directory once per process."""
    jax_mips._dir_entry_index.cache_clear()
    torch_mips._dir_entry_index.cache_clear()


def _both(tmp_path, out_name, *argv):
    """Run the command in both packages (into port/ and jax/ under
    tmp_path); the output files must be byte-identical. Returns the
    port's bytes."""
    argv = [str(a) for a in argv]
    got = {}
    for name, main in (("port", torch_main.main), ("jax", jax_main.main)):
        _clear_caches()
        assert main([*argv, "-od", str(tmp_path / name)]) == 0
        got[name] = (tmp_path / name / out_name).read_bytes()
    assert got["port"] == got["jax"]
    return got["port"]


V3_CASES = {
    "dir_variants": ["-i", "lm", "--gradients-location", "grad",
                     "--zgap-location", "zgap", "zgap_missing",
                     "-l", "mylib", "-as", "JRC2018_Unisex_20x_HR"],
    "zip_variants": ["-i", "lib.zip:1:3", "--gradients-location",
                     "grads.zip", "--zgap-location", "zgap",
                     "--gradient-suffix", "_gradient"],
    "lm_segmented": ["-i", "lm", "--type", "lm", "--segmented-mips", "seg",
                     "--gradients-location", "grad"],
    "lm_segmented_base0": ["-i", "lm", "--segmented-mips", "seg",
                           "--segmentation-channel-base", "0"],
    "em_states": ["-i", "em", "--type", "em", "-l", "flyem_hemibrain",
                  "--segmented-mips", "emseg", "--match-neuron-state"],
    "em_no_states": ["-i", "em", "-l", "flyem_hemibrain",
                     "--segmented-mips", "emseg"],
    "em_as_lm": ["-i", "em", "--type", "lm", "-l", "flyem_hemibrain"],
    "filters": ["-i", "lm", "--excluded-neurons", "sc2-line_20x_ch1_CDM",
                "--tag", "t1", "t2", "--no-pretty-print"],
    "included": ["-i", "lm", "--included-neurons", "sc1-line_40x_ch2_CDM",
                 "sc3-line_CDM", "--mips", "sc3-line_CDM"],
}


@pytest.mark.parametrize("case", sorted(V3_CASES))
def test_data_input_identical_to_jax(lib, tmp_path, monkeypatch, case):
    monkeypatch.chdir(lib)
    data = _both(tmp_path, "in.json", "createColorDepthSearchDataInput",
                 *V3_CASES[case], "--output-filename", "in.json")
    assert data.count(b"InputColorDepthImage") >= 1
    if case == "dir_variants":
        assert data.count(b"GradientImage") == 3
        assert b"grad/lm/sc1-line_40x_ch2_CDM_gradient.png" in data
        assert b"pre-sc2-line_20x_ch1_CDM_gradient-x.png" in data
        assert data.count(b"ZGapImage") == 2
    if case == "em_states":
        assert b"12345-LV_18U_FL.png" in data
        assert b"12345-TC_18U_FL.png" not in data


def test_data_input_for_update_identical_to_jax(lib, tmp_path, monkeypatch):
    """--for-update merges into the existing file: entries with the same
    mipId are replaced, the rest kept."""
    monkeypatch.chdir(lib)
    argv = ["createColorDepthSearchDataInput", "--output-filename",
            "in.json"]
    for name, main in (("port", torch_main.main), ("jax", jax_main.main)):
        assert main([*argv, "-i", "lm:0:2", "-od",
                     str(tmp_path / name)]) == 0
    data = _both(tmp_path, "in.json", *argv, "-i", "lm:1:3", "--for-update",
                 "--tag", "again", "--gradients-location", "grad")
    assert data.count(b'"mipId"') == 4
    assert data.count(b"again") == 3


@pytest.mark.parametrize("spec", [["-i", "lm"],
                                  ["-i", "lib.zip:1:2", "-l", "a", "b"],
                                  ["-i", "em", "-as", "JRC2018_VNC",
                                   "--no-pretty-print"]])
def test_json_input_identical_to_jax(lib, tmp_path, monkeypatch, spec):
    """createColorDepthSearchJSONInput, local mode, over a directory and a
    zip entry range."""
    monkeypatch.chdir(lib)
    out = "a.json" if "-l" in spec else f"{spec[1]}.json"
    data = _both(tmp_path, out, "createColorDepthSearchJSONInput", *spec)
    assert b'"imageType"' in data


FIND_VARIANT_CASES = [
    # (mip file, locations, suffix, cdm_suffix)
    ("lm/sc1-line_40x_ch2_CDM.png", ["grad"], "_gradient", None),
    ("other/sc1-line_40x_ch2_CDM.png", ["grad"], "_gradient", None),
    ("lm/sc2-line_20x_ch1_CDM.png", ["grad"], "_gradient", None),
    ("lm/sc3-line_CDM.png", ["grad"], "_gradient", None),
    ("lm/sc3-line_CDM.png", ["grad"], "_gradient", "_CDM"),
    ("lm/sc4-line_ch1_CDM.png", ["grad"], "_gradient", None),
    ("lm/sc4-line_ch1_CDM.png", ["zgap"], "_20pxRGB", None),
    ("lm/sc2-line_20x_ch1_CDM.png", ["zgap"], "_20pxRGB", None),
    ("lm/sc1-line_40x_ch2_CDM.png", ["missing", "zgap"], "_20pxRGB", None),
    ("lm/sc1-line_40x_ch2_CDM.png", ["grads.zip"], "_gradient", None),
    ("lm/sc2-line_20x_ch1_CDM.png", ["grads.zip"], "_gradient", None),
    ("lm/sc3-line_CDM.png", ["grads.zip"], "_gradient", "_CDM"),
    ("lm/sc3-line_CDM.png", ["grads.zip", "grad"], "_gradient", None),
    ("lm/sc1-line_40x_ch2_CDM.png", ["grad"], None, None),
]


@pytest.mark.parametrize("case", FIND_VARIANT_CASES,
                         ids=[f"{i}" for i in range(len(FIND_VARIANT_CASES))])
def test_find_variant_matches_jax(lib, case):
    mip, locations, suffix, cdm_suffix = case
    locations = [str(lib / loc) for loc in locations]
    _clear_caches()
    got = torch_mips.find_variant(torch_model.FileData(str(lib / mip)),
                                  locations, suffix, cdm_suffix=cdm_suffix)
    want = jax_mips.find_variant(jax_model.FileData(str(lib / mip)),
                                 locations, suffix, cdm_suffix=cdm_suffix)
    assert (got is None) == (want is None)
    if want is not None:
        assert (got.file_name, got.entry_name) == \
            (want.file_name, want.entry_name)
        assert torch_mips.exists(got)


LOOKUP_CASES = [
    # (neuron class, constructor kwargs, source image, seg dir, channel
    # base, match neuron state)
    ("LMNeuron", dict(mip_id="m", slide_code="sc1", channel=2,
                      objective="40x", library_name="MCFO"),
     None, "seg", 1, False),
    ("LMNeuron", dict(mip_id="m", slide_code="sc1", channel=2,
                      library_name="MCFO"), None, "seg", 1, False),
    ("LMNeuron", dict(mip_id="m", slide_code="sc1", channel=2,
                      objective="20x", library_name="MCFO"),
     None, "seg", 0, False),
    ("LMNeuron", dict(mip_id="m", published_name="sc2-line_20x_ch1_CDM",
                      library_name="MCFO"), None, "seg", 1, False),
    ("LMNeuron", dict(mip_id="m", slide_code="sc9"), None, "seg", 1, False),
    ("EMNeuron", dict(mip_id="m", published_name="12345",
                      library_name="flyem_hemibrain"),
     "/store/12345-L_18U.tif", "emseg", 1, True),
    ("EMNeuron", dict(mip_id="m", published_name="12345",
                      library_name="flyem_hemibrain"),
     "/store/12345-TC_18U.png", "emseg", 1, True),
    ("EMNeuron", dict(mip_id="m", published_name="12345",
                      library_name="flyem_hemibrain"), None, "emseg", 1,
     False),
    ("EMNeuron", dict(mip_id="34567_18U", published_name="34567_18U",
                      library_name="flyem_hemibrain"),
     "/store/34567_18U.png", "emseg", 1, True),
    ("EMNeuron", dict(mip_id="23456-TC_18U", published_name="x",
                      library_name="flyem_hemibrain"), None, "emseg", 1,
     False),
]


@pytest.mark.parametrize("case", LOOKUP_CASES,
                         ids=[f"{i}" for i in range(len(LOOKUP_CASES))])
def test_lookup_searchable_images_matches_jax(lib, case):
    cls, kwargs, source, seg, base, state = case
    found = {}
    for name, model, naming in (("port", torch_model, torch_naming),
                                ("jax", jax_model, jax_naming)):
        neuron = getattr(model, cls)(**kwargs)
        if source is not None:
            neuron.set_compute_file(
                model.ComputeFileType.SourceColorDepthImage, source)
        index = naming.index_segmented_images([str(lib / seg)])
        found[name] = [(fd.file_name, fd.entry_name)
                       for fd in naming.lookup_searchable_images(
                           neuron, index, channel_base=base,
                           match_neuron_state=state)]
    assert found["port"] == found["jax"]


@pytest.mark.parametrize("name", ["VT056372-xx-f_CL3_ch2_001.tif",
                                  "R10A07-aaa-40x-CH3-02.png",
                                  "sample-c1.tif", "no_channel_here.tif",
                                  "12345-LV_18U", "1752016801-LPLC2-RT_18U"
                                  ".tif", "noid.tif", "x_ch2_.tif"])
def test_name_parsers_match_jax(name):
    for fn, args in (("extract_color_channel", (1,)),
                     ("extract_color_channel", (0,)),
                     ("extract_objective", ()),
                     ("extract_em_body_id", ()),
                     ("extract_em_neuron_state", ()),
                     ("is_em_library", ())):
        assert getattr(torch_naming, fn)(name, *args) == \
            getattr(jax_naming, fn)(name, *args)
