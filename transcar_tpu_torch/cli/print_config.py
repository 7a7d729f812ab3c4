"""Config sanity CLI (tools/misc/print_config.py analog;
``transcar_tpu/cli/print_config.py``): the preset with its overrides as
JSON.  Host only: it needs no device."""
from __future__ import annotations

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("preset")
    ap.add_argument("--cfg-options", nargs="*", default=[])
    args = ap.parse_args(argv)

    from transcar_tpu_torch.core.config import (config_to_dict, get_preset,
                                                parse_overrides)

    cfg = get_preset(args.preset, parse_overrides(args.cfg_options))
    print(json.dumps(config_to_dict(cfg), indent=2))


if __name__ == "__main__":
    main()
