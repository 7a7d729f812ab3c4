"""The tables ``chip_smoke.py`` holds the card to, checked on the CPU: the
knock-out variants' text patches against the kernel sources (a patch
whose text is gone raises only on the card) and the int8 slices' conv
shapes and counts against the presets' launches."""
import pathlib

import pytest

import chip_smoke
from transcar_tpu_torch.ops import int8

CSRC = pathlib.Path(chip_smoke.__file__).parent / "transcar_tpu_torch" / "csrc"


@pytest.mark.parametrize("name", sorted(chip_smoke.VARIANTS))
def test_variant_patches_find_their_text(name):
    sources, patches = chip_smoke.VARIANTS[name]
    assert all((CSRC / f).exists() for f in sources)
    for target, old, _ in patches:
        assert target in sources
        assert old in (CSRC / target).read_text(), (name, target)
    assert name.split(" ", 1)[0] in chip_smoke.VARIANT_KINDS


@pytest.mark.parametrize("preset", sorted(chip_smoke.INT8_SLICES))
def test_int8_shapes_give_the_slice_counts(preset):
    # the architectures' conv shapes (phase 21 checks the recorded calls
    # against them) sum to the counts a request, the stems off the wgmma
    # tile
    per = chip_smoke.int8_main_shapes()[preset]
    want = chip_smoke.INT8_SLICES[preset]
    assert sum(per.values()) == want["int8_conv"]
    assert sum(k for (_, cin, _, _, cout, *_), k in per.items()
               if int8.takes_wgmma(cin, cout)) == want["int8_wgmma"]
    assert len(per) == {"transcar_r101": 18,
                        "transcar_vovnet_trainval": 13}[preset]
