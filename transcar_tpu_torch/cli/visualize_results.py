"""Results inspection CLI (tools/misc/visualize_results.py analog,
headless; ``transcar_tpu/cli/visualize_results.py``): prints per-sample
detection summaries from a submission json, and with ``--save-dir``
renders BEV PNGs (``eval/bev_plot.py``).  Host only: it needs no device."""
from __future__ import annotations

import argparse
import json
from collections import Counter


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("results_json")
    ap.add_argument("--num", type=int, default=5)
    ap.add_argument("--score-thr", type=float, default=0.3)
    ap.add_argument("--save-dir",
                    help="also render BEV PNGs into this directory")
    args = ap.parse_args(argv)

    if args.save_dir:
        from transcar_tpu_torch.eval.bev_plot import render_submission
        render_submission(args.results_json, args.save_dir,
                          score_thr=args.score_thr)

    with open(args.results_json) as f:
        sub = json.load(f)
    results = sub["results"]
    print(f"{len(results)} samples, meta={sub.get('meta')}")
    all_counts = Counter()
    for i, (token, annos) in enumerate(results.items()):
        kept = [a for a in annos
                if a["detection_score"] >= args.score_thr]
        counts = Counter(a["detection_name"] for a in kept)
        all_counts.update(counts)
        if i < args.num:
            tops = ", ".join(f"{k}×{v}" for k, v in counts.most_common(5))
            print(f"[{i}] {token}: {len(kept)} dets ≥{args.score_thr} "
                  f"({tops})")
    print("totals:", dict(all_counts.most_common()))


if __name__ == "__main__":
    main()
