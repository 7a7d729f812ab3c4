"""The port's copy of the configuration against the JAX package's.

``transcar_tpu_torch/core/config.py`` keeps its own copy of the
dataclasses, the presets and the ``--cfg-options`` override semantics,
because the port never loads a file of ``transcar_tpu``.  These tests
hold every preset equal, field by field, to the JAX ``get_preset``, with
and without overrides, so the two copies cannot drift apart unnoticed.
"""
import dataclasses

import pytest

from transcar_tpu.cli.train import parse_overrides as jax_parse_overrides
from transcar_tpu.core import config as jcfg
from transcar_tpu_torch.core import config as pcfg

OVERRIDES = [
    "model.backbone.kind=resnet50",
    "model.backbone.compute_dtype=float32",
    "model.backbone.with_dcn=[false,false,true,false]",
    "model.head.num_query=16",
    "model.head.fusion_radius_clamps=[[1.0,2.0],[0.5,1.0]]",
    "model.use_grid_mask=false",
    "train.optim.lr=1e-4",
    "data.img_hw=[64,96]",
    "train.work_dir=/some/where",
]


def test_same_presets():
    assert pcfg.list_presets() == jcfg.list_presets()


@pytest.mark.parametrize("name", jcfg.list_presets())
def test_preset_equal_field_by_field(name):
    assert (dataclasses.asdict(pcfg.get_preset(name))
            == dataclasses.asdict(jcfg.get_preset(name)))


@pytest.mark.parametrize("name", ["transcar_r101", "detr3d_r101"])
def test_preset_equal_with_overrides(name):
    ours = pcfg.parse_overrides(OVERRIDES)
    assert ours == jax_parse_overrides(OVERRIDES)
    a = dataclasses.asdict(pcfg.get_preset(name, ours))
    b = dataclasses.asdict(jcfg.get_preset(name, ours))
    assert a == b
    assert a["model"]["backbone"]["kind"] == "resnet50"
    assert a["model"]["head"]["num_query"] == 16


def test_dataclass_fields_and_defaults_equal():
    for cls in ("BackboneConfig", "HeadConfig", "ModelConfig", "DataConfig",
                "OptimConfig", "TrainConfig", "TransCARConfig"):
        ours, ref = getattr(pcfg, cls), getattr(jcfg, cls)
        assert ([(f.name, str(f.type)) for f in dataclasses.fields(ours)]
                == [(f.name, str(f.type)) for f in dataclasses.fields(ref)])
        assert dataclasses.asdict(ours()) == dataclasses.asdict(ref()), cls


def test_unknown_preset_raises():
    with pytest.raises(KeyError, match="unknown preset"):
        pcfg.get_preset("nope")
