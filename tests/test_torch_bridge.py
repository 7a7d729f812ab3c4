"""The weight bridge: every leaf of the JAX package's parameter tree maps
onto the port's ``state_dict`` and nothing is left over (strict load)."""
import numpy as np
import jax
import pytest
import torch

from transcar_tpu.core.config import get_preset
from transcar_tpu.models.detector import build_model as jax_build_model
from transcar_tpu_torch.models.detector import build_model
from transcar_tpu_torch.train.convert import from_jax_params

torch.set_num_threads(2)       # Tier-1 runs 6 xdist workers


def _jax_tree(preset, overrides):
    """Shapes of the preset's flax tree (``jax.eval_shape``: no compute),
    filled with distinct values."""
    cfg = get_preset(preset, overrides)
    b, n, h, w = 1, cfg.model.head.num_cams, 64, 96
    args = (np.zeros((b, n, h, w, 3), np.float32),
            np.zeros((b, n, 4, 4), np.float32),
            np.zeros((b, cfg.model.head.num_radar_tokens, 36), np.float32))
    shapes = jax.eval_shape(jax_build_model(cfg).init,
                            jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(0)
    return cfg, jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)


@pytest.mark.parametrize("preset", ["transcar_r101", "detr3d_r101"])
def test_strict_load_of_the_flax_tree(preset):
    # full-width R101-DCN and head; fewer queries keep the arrays small
    cfg, params = _jax_tree(preset, {"model.head.num_query": 16})
    sd = from_jax_params(params)
    n_leaves = len(jax.tree_util.tree_leaves(params))
    assert len(sd) == n_leaves
    model = build_model(cfg, device="cpu")
    result = model.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    # layout rules: conv [kh,kw,I,O] → [O,I,kh,kw]; Dense [I,O] → [O,I];
    # attention w* stay [in, out]
    p = params["params"]
    np.testing.assert_array_equal(
        model.backbone.layer3_0.conv2.weight.detach().numpy(),
        p["backbone"]["layer3_0"]["conv2"]["weight"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        model.head.reference_points.weight.detach().numpy(),
        p["head"]["reference_points"]["kernel"].T)
    np.testing.assert_array_equal(
        model.head.decoder_layer0.self_attn.wq.detach().numpy(),
        p["head"]["decoder_layer0"]["self_attn"]["wq"])
    np.testing.assert_array_equal(
        model.backbone.stem.bn.running_var.numpy(),
        p["backbone"]["stem"]["bn"]["var"])
    # the bridge takes the tree with or without its top-level "params"
    assert from_jax_params(p).keys() == sd.keys()
