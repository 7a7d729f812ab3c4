"""Dataset inspection CLI (tools/misc/browse_dataset.py analog, headless;
``transcar_tpu/cli/browse_dataset.py``): prints a summary of each
sample's pipeline output (``data/loader.prepare_sample``, training mode)
instead of rendering images.  Host only: it needs no device."""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("preset", nargs="?", default="transcar_r101")
    ap.add_argument("--num", type=int, default=3)
    ap.add_argument("--cfg-options", nargs="*", default=[])
    args = ap.parse_args(argv)

    import os
    import numpy as np
    from transcar_tpu_torch.core.config import get_preset, parse_overrides
    from transcar_tpu_torch.data.infos import NuScenesInfos
    from transcar_tpu_torch.data.loader import prepare_sample

    cfg = get_preset(args.preset, parse_overrides(args.cfg_options))
    ds = NuScenesInfos(os.path.join(cfg.data.data_root, cfg.data.ann_train),
                       data_root=cfg.data.data_root)
    print(f"{len(ds)} samples")
    for i in range(min(args.num, len(ds))):
        s = ds.get_sample(i)
        try:
            out = prepare_sample(s, cfg.data, training=True,
                                 rng=np.random.default_rng(i))
            img = out["images"]
            print(f"[{i}] token={s.token} imgs={img.shape} "
                  f"range=[{img.min():.1f},{img.max():.1f}] "
                  f"gt={int(out['num_gt'])} "
                  f"classes={sorted(set(s.gt_labels.tolist()))}")
        except FileNotFoundError as e:
            print(f"[{i}] token={s.token} gt={len(s.gt_labels)} "
                  f"(images unavailable: {e})")


if __name__ == "__main__":
    main()
