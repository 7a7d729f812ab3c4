"""The port's kernels and end-to-end steps against an earlier tree's, in
turns, on one card.

Run from the repo root, with an earlier commit unpacked into a directory
that ``.gitignore`` lists (``git archive <commit> | tar -x -C _archive/parent``):

    python3 scripts/torch_turns.py --parent _archive/parent k3 k4 k5 k8k9 e2e

Parts (all when none is named):

* ``k3``, ``k4``, ``k5``, ``k8k9``: ``chip_smoke.py``'s kernel phases with
  the parent's ``csrc`` built beside this tree's (``--parent-csrc``): each
  kernel timed in turns with the parent's on the same inputs;
* ``repeat``: ``chip_smoke.py`` phase 28 (every serving configuration and
  train step twice, bit for bit);
* ``profile``: ``torch.profiler`` tables of K3's and K9's device kernels
  at a ``detr3d_r101`` layer-3 conv and a pillar encoder call;
* ``e2e``: ``cli.benchmark`` (``--samples 10 --warmup 3``) of a
  ``detr3d_r101``, ``transcar_r101``, pillar and voxel train step and a
  VoVNet request, run by the parent tree and this one in the order parent,
  change, change, parent (one process each); then one traced run of each
  (``--trace-dir``) by each tree, its device busy time, idle share and
  trace groups.

Every line names the card and its power limit.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from transcar_tpu_torch.core.device import set_deterministic  # noqa: E402

PARTS = ("k3", "k4", "k5", "k8k9", "repeat", "profile", "e2e")
E2E = (("detr3d_r101 step", ["detr3d_r101", "--train"]),
       ("transcar_r101 step", ["transcar_r101", "--train"]),
       ("pillar step", ["objdgcnn_pillar", "--train"]),
       ("voxel step", ["objdgcnn_voxel", "--train"]),
       ("VoVNet request", ["transcar_vovnet_trainval"]))


def _benchmark(tree: str, argv: list, env: dict) -> dict:
    """The JSON line of one ``cli.benchmark`` process run in ``tree``."""
    cmd = [sys.executable, "-m", "transcar_tpu_torch.cli.benchmark", *argv]
    r = subprocess.run(cmd, cwd=tree, env=env, capture_output=True,
                       text=True)
    if r.returncode != 0:
        print(r.stdout[-3000:], r.stderr[-3000:])
        raise SystemExit(f"{' '.join(argv)} in {tree} failed")
    return json.loads(r.stdout.strip().splitlines()[-1])


def profile_tables(smi: str) -> None:
    """Device-kernel tables of K3 (layer-3 conv, offsets ±8) and K9 (a
    pillar encoder call), five calls each after three warm ones."""
    from torch.profiler import ProfilerActivity, profile

    from transcar_tpu_torch.ops import pallas_dcn, pallas_msdeform

    g = torch.Generator(device="cuda").manual_seed(3)
    x, om, wt, d_out = cs.dcn_backward_case(g, 6, 58, 100, 256, 256,
                                            torch.bfloat16, "pm8")
    s = sum(h * w for h, w in cs.BEV_LEVELS)
    value, loc, wgt = cs.msdeform_case(g, s, True)
    dv_out = torch.randn(1, loc.shape[1], 256, device="cuda", generator=g)
    for tag, fn in (
            ("K3 layer-3 pm8",
             lambda: pallas_dcn.backward_kernel(x, om, wt, d_out)),
            ("K9 encoder", lambda: pallas_msdeform.backward_value_kernel(
                value, cs.BEV_LEVELS, loc, wgt, dv_out))):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        print(f"profile {tag} (5 calls, {smi}):")
        print(prof.key_averages().table(sort_by="cuda_time_total",
                                        row_limit=14), flush=True)


def end_to_end(parent: str, smi: str) -> None:
    """Each :data:`E2E` case by the parent and this tree in turns, then one
    traced run of each by each."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for label, argv in E2E:
        got = []
        for tree in (parent, ".", ".", parent):
            rec = _benchmark(tree, [*argv, "--samples", "10", "--warmup",
                                    "3"], env)
            got.append(rec.get("ms_per_step", rec.get("ms_per_sample")))
        print(f"e2e {label} ms parent / change / change / parent: "
              + " / ".join(f"{v:.2f}" for v in got) + f" ({smi})",
              flush=True)
    traces = tempfile.mkdtemp(prefix="turns_traces_")
    for tree, tag in ((parent, "parent"), (".", "change")):
        for label, argv in E2E:
            d = os.path.join(traces, f"{label.replace(' ', '_')}_{tag}")
            tr = _benchmark(tree, [*argv, "--samples", "3", "--warmup", "3",
                                   "--trace-dir", d], env)["trace"]
            groups = sorted(tr["ms_per_iter_by_group"].items(),
                            key=lambda kv: -kv[1])
            print(f"trace {label} {tag}: wall {tr['wall_ms_per_iter']:.2f} "
                  f"ms, busy {tr['device_busy_ms_per_iter']:.2f} ms, idle "
                  f"{tr['device_idle_share']:.3f}, kernels "
                  f"{tr['kernels_per_iter']:.0f}; " + ", ".join(
                      f"{g} {v:.2f}" for g, v in groups) + f" ({smi})",
                  flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="an earlier tree of this repo, unpacked")
    ap.add_argument("parts", nargs="*", choices=PARTS, default=list(PARTS))
    args = ap.parse_args(argv)
    set_deterministic("cuda")
    smi = cs.phase_device()
    cs.phase_build()
    parent = cs.parent_library(os.path.join(args.parent, "transcar_tpu_torch",
                                            "csrc"))
    for name, fn in (("k3", cs.phase_k3), ("k4", cs.phase_k4),
                     ("k5", cs.phase_k5), ("k8k9", cs.phase_k8_k9)):
        if name in args.parts:
            t0 = time.perf_counter()
            res = fn(parent)
            print(f"phase {name} {time.perf_counter() - t0:.1f} s: "
                  + json.dumps(res, default=str)[:600], flush=True)
    if "repeat" in args.parts:
        t0 = time.perf_counter()
        cs.phase_repeat(smi)
        print(f"phase repeat {time.perf_counter() - t0:.1f} s", flush=True)
    if "profile" in args.parts:
        profile_tables(smi)
    if "e2e" in args.parts:
        end_to_end(args.parent, smi)


if __name__ == "__main__":
    main()
