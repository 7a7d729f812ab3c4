"""Log analysis CLI (tools/analysis_tools/analyze_logs.py analog;
``transcar_tpu/cli/analyze_logs.py``).  Host only: it needs no device.

Parses the json-line train logs written by ``train/loop.JsonLogger``:
``cal_train_time`` prints per-epoch iteration-time statistics
(reference :10-30); ``plot_curve`` renders metric curves to PNG via
matplotlib-Agg (reference :33-106 — train mode plots per-iter series on
a global-iteration axis, eval mode plots per-epoch val metrics with
markers) and falls back to a CSV dump when matplotlib is unavailable or
the output path ends in ``.csv``.
"""
from __future__ import annotations

import argparse
import json
from collections import defaultdict


def load_records(path):
    with open(path) as f:
        return [json.loads(l) for l in f if l.strip()]


def cal_train_time(records):
    by_epoch = defaultdict(list)
    for r in records:
        if r.get("mode") == "train" and "time" in r:
            by_epoch[r["epoch"]].append(r["time"])
    print(f"{'epoch':>6} {'mean(s/iter)':>14} {'min':>8} {'max':>8}")
    alltimes, means = [], {}
    for e in sorted(by_epoch):
        ts = by_epoch[e]
        alltimes += ts
        means[e] = sum(ts) / len(ts)
        print(f"{e:>6} {means[e]:>14.4f} {min(ts):>8.4f} "
              f"{max(ts):>8.4f}")
    if alltimes:
        # reference also reports the extremes (analyze_logs.py:20-28)
        slowest = max(means, key=means.get)
        fastest = min(means, key=means.get)
        print(f"slowest epoch {slowest}, average time is "
              f"{means[slowest]:.4f}")
        print(f"fastest epoch {fastest}, average time is "
              f"{means[fastest]:.4f}")
        print(f"overall mean: {sum(alltimes)/len(alltimes):.4f} s/iter")


def _series(records, keys, mode):
    """metric → (xs, ys).  Train mode: x = global iteration (epoch-1) ·
    iters/epoch + iter (reference :85-99); eval mode: x = epoch."""
    out = {}
    if mode == "train":
        train = [r for r in records if r.get("mode") == "train"]
        iters_per_epoch = max((r.get("iter", 0) for r in train),
                              default=0)
        for k in keys:
            pts = [((r["epoch"] - 1) * iters_per_epoch + r["iter"], r[k])
                   for r in train
                   if k in r and r.get(k) is not None]
            out[k] = ([x for x, _ in pts], [y for _, y in pts])
    else:
        val = [r for r in records if r.get("mode") == "val"]
        for k in keys:
            pts = [(r["epoch"], r[k]) for r in val
                   if k in r and isinstance(r.get(k), (int, float))]
            out[k] = ([x for x, _ in pts], [y for _, y in pts])
    return out


def _write_csv(series, keys, out_csv, xlabel):
    rows = sorted({x for xs, _ in series.values() for x in xs})
    byx = {k: dict(zip(*series[k])) for k in keys}
    with open(out_csv, "w") as f:
        f.write(f"{xlabel}," + ",".join(keys) + "\n")
        for x in rows:
            vals = [byx[k].get(x) for k in keys]
            f.write(",".join([str(x)] + ["" if v is None else str(v)
                                         for v in vals]) + "\n")
    print(f"wrote {len(rows)} rows to {out_csv}")
    return out_csv


def plot_curve(records, keys, out, mode="train", title=None,
               legends=None):
    xlabel = "iter" if mode == "train" else "epoch"
    series = _series(records, keys, mode)
    missing = [k for k in keys if not series[k][0]]
    if missing:
        print(f"warning: no {mode}-mode values for {missing}")
    if out.endswith(".csv"):
        return _write_csv(series, keys, out, xlabel)
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        csv = out.rsplit(".", 1)[0] + ".csv"
        print(f"matplotlib unavailable; dumping CSV to {csv}")
        return _write_csv(series, keys, csv, xlabel)

    fig, ax = plt.subplots(figsize=(8, 5))
    legends = legends or keys
    for k, leg in zip(keys, legends):
        xs, ys = series[k]
        if mode == "train":
            ax.plot(xs, ys, label=leg, linewidth=0.8)
        else:
            ax.plot(xs, ys, label=leg, marker="o")
            ax.set_xticks(xs)
    ax.set_xlabel(xlabel)
    ax.legend()
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    plt.close(fig)
    print(f"save curve to: {out}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="task", required=True)
    t = sub.add_parser("cal_train_time")
    t.add_argument("json_logs", nargs="+")
    p = sub.add_parser("plot_curve")
    p.add_argument("json_logs", nargs="+")
    p.add_argument("--keys", nargs="+", default=["loss_cls", "loss_bbox"])
    p.add_argument("--out", default="curve.png")
    p.add_argument("--mode", choices=["train", "eval"], default="train",
                   help="train: per-iter loss curves; eval: per-epoch "
                        "val metrics (reference --mode semantics)")
    p.add_argument("--title")
    p.add_argument("--legend", nargs="+")
    args = ap.parse_args(argv)

    for path in args.json_logs:
        records = load_records(path)
        print(f"== {path} ==")
        if args.task == "cal_train_time":
            cal_train_time(records)
        else:
            plot_curve(records, args.keys, args.out, mode=args.mode,
                       title=args.title, legends=args.legend)


if __name__ == "__main__":
    main()
