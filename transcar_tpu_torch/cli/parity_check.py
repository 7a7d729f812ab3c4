"""Real-data numeric parity harness against the reference implementation
(``transcar_tpu/cli/parity_check.py``).

Weights in, boxes out: the published TransCAR / DETR3D checkpoints and the
nuScenes data are not in the repository, so this makes the check one
command once they are there:

  1. Capture reference outputs beside the reference repo (its own env):
         python scripts/capture_reference_outputs.py \\
             <config.py> <ckpt.pth> --out ref_outputs.npz --max-samples 50
  2. Run the same samples through the port and diff:
         python -m transcar_tpu_torch.cli.parity_check transcar_r101 \\
             --checkpoint ckpt.pth --reference-npz ref_outputs.npz \\
             --cfg-options data.data_root=/path/to/nuscenes

Capture format (``np.savez``): ``tokens`` [N] <U..>, ``boxes`` [N, K, 9]
(bottom-centre, decode order), ``scores`` [N, K], ``labels`` [N, K] int,
``num_dets`` [N] int.  Rows are sorted by descending score (the reference
NMSFreeCoder's top-k and ``eval/decode.py`` emit that order), so rows are
compared index-aligned.  The format is the JAX package's: an npz captured
by either package compares in the other.

:func:`capture_outputs` writes the same format from the port, so a
convert → forward → capture → compare round trip checks the harness
without reference artifacts.  Both functions run the port's eval path
(``train/step.eval_step`` on ``data/loader.PrefetchLoader`` batches) on
the model's device; the CLI takes the card unless ``--device cpu`` is
given, and raises without CUDA.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Callable, Dict, Optional

import numpy as np


def _val_dataset(cfg):
    from transcar_tpu_torch.data.infos import NuScenesInfos
    return NuScenesInfos(os.path.join(cfg.data.data_root, cfg.data.ann_val),
                         class_names=cfg.data.class_names, test_mode=True,
                         data_root=cfg.data.data_root)


def _decoded(model, cfg, dataset, indices, radar_fn):
    """(position, decoded rows on the host) for each of ``indices``, one
    sample a batch, through ``train/step.eval_step``."""
    from transcar_tpu_torch.data.loader import PrefetchLoader, to_device
    from transcar_tpu_torch.train.step import eval_step

    device = next(model.parameters()).device
    loader = PrefetchLoader(dataset, cfg.data, batch_size=1,
                            training=False, indices=np.asarray(indices),
                            radar_fn=radar_fn,
                            modality="lidar" if cfg.model.lidar_encoder
                            else "camera")
    for i, batch in enumerate(loader.epoch(0)):
        out = eval_step(model, to_device(batch, device), cfg)
        yield i, {k: v[0].cpu().numpy() for k, v in out.items()}


def capture_outputs(cfg, model, out_npz: str,
                    max_samples: Optional[int] = None,
                    radar_fn: Optional[Callable] = None,
                    dataset=None) -> str:
    """Forward the val split with ``model`` (eval mode, on its device) and
    save the decoded outputs in the capture format (the port's twin of
    ``scripts/capture_reference_outputs.py``)."""
    if dataset is None:
        dataset = _val_dataset(cfg)
    n = len(dataset) if max_samples is None else min(max_samples,
                                                     len(dataset))
    tokens, boxes, scores, labels, num_dets = [], [], [], [], []
    for idx, out in _decoded(model, cfg, dataset, np.arange(n), radar_fn):
        tokens.append(dataset.infos[idx]["token"])
        boxes.append(out["boxes"].astype(np.float32))
        scores.append(out["scores"].astype(np.float32))
        labels.append(out["labels"].astype(np.int32))
        num_dets.append(int(out["valid"].sum()))
    np.savez(out_npz, tokens=np.asarray(tokens),
             boxes=np.stack(boxes), scores=np.stack(scores),
             labels=np.stack(labels),
             num_dets=np.asarray(num_dets, np.int32))
    return out_npz


def compare_outputs(cfg, model, reference_npz: str,
                    radar_fn: Optional[Callable] = None,
                    box_tol: float = 0.05, score_tol: float = 0.01,
                    top_k: int = 50, num_det_slack: int = 0,
                    dataset=None) -> Dict:
    """Forward every captured sample with ``model`` and diff against the
    capture.

    Compares the ``top_k`` highest-score detections index-aligned: box
    L∞ in metres / state units, score L∞, and label agreement.  The
    compared row count is ``min(top_k, reference num_dets)``, not capped
    by the port's own valid count, so a model that drops detections the
    reference kept is compared (and fails) instead of passing vacuously.
    Detection counts must agree within ``num_det_slack``.  Returns a
    report dict; the check passes when every per-sample deviation is
    within tolerance.
    """
    ref = np.load(reference_npz, allow_pickle=False)
    ref_tokens = [str(t) for t in ref["tokens"]]
    if dataset is None:
        dataset = _val_dataset(cfg)
    token_to_idx = {info["token"]: i for i, info in enumerate(dataset.infos)}
    missing = [t for t in ref_tokens if t not in token_to_idx]
    if missing:
        raise ValueError(
            f"{len(missing)} captured tokens not in {cfg.data.ann_val}, "
            f"e.g. {missing[:3]} — val split mismatch")

    indices = [token_to_idx[t] for t in ref_tokens]
    per_sample = []
    for i, out in _decoded(model, cfg, dataset, indices, radar_fn):
        k = min(top_k, int(ref["num_dets"][i]))
        ours_b = out["boxes"][:k].astype(np.float64)
        ours_s = out["scores"][:k].astype(np.float64)
        ours_l = out["labels"][:k]
        ref_b = np.asarray(ref["boxes"][i][:k], np.float64)
        ref_s = np.asarray(ref["scores"][i][:k], np.float64)
        ref_l = np.asarray(ref["labels"][i][:k])
        per_sample.append({
            "token": ref_tokens[i],
            "k": k,
            "num_dets_ours": int(out["valid"].sum()),
            "num_dets_ref": int(ref["num_dets"][i]),
            "box_max_abs": float(np.abs(ours_b - ref_b).max()) if k else 0.0,
            "score_max_abs": (float(np.abs(ours_s - ref_s).max())
                              if k else 0.0),
            "label_agree": (float((ours_l == ref_l).mean()) if k else 1.0),
        })

    box_max = max((s["box_max_abs"] for s in per_sample), default=0.0)
    score_max = max((s["score_max_abs"] for s in per_sample), default=0.0)
    label_min = min((s["label_agree"] for s in per_sample), default=1.0)
    det_diff_max = max((abs(s["num_dets_ours"] - s["num_dets_ref"])
                        for s in per_sample), default=0)
    return {
        "n_samples": len(per_sample),
        "compared_rows": int(sum(s["k"] for s in per_sample)),
        "box_max_abs": box_max,
        "score_max_abs": score_max,
        "label_agree_min": label_min,
        "num_det_diff_max": det_diff_max,
        "box_tol": box_tol,
        "score_tol": score_tol,
        "passed": bool(box_max <= box_tol and score_max <= score_tol
                       and label_min == 1.0
                       and det_diff_max <= num_det_slack),
        "per_sample": per_sample,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("preset")
    ap.add_argument("--checkpoint", required=True,
                    help="reference torch .pth (converted on load), a "
                         "training step dir or a params-only file")
    ap.add_argument("--reference-npz", required=True,
                    help="captured reference outputs "
                         "(scripts/capture_reference_outputs.py)")
    ap.add_argument("--box-tol", type=float, default=0.05)
    ap.add_argument("--score-tol", type=float, default=0.01)
    ap.add_argument("--top-k", type=int, default=50)
    ap.add_argument("--num-det-slack", type=int, default=0,
                    help="allowed |num_dets_ours − num_dets_ref| per "
                         "sample (0 = exact count parity)")
    ap.add_argument("--report-out", help="write the full json report here")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without CUDA) or cpu")
    ap.add_argument("--cfg-options", nargs="*", default=[])
    args = ap.parse_args(argv)

    from transcar_tpu_torch.cli.train import _try_radar_fn
    from transcar_tpu_torch.core.config import get_preset, parse_overrides
    from transcar_tpu_torch.core.device import set_deterministic
    from transcar_tpu_torch.models.detector import build_model
    from transcar_tpu_torch.train.loop import _load_params, resolve_device

    set_deterministic(args.device)     # before anything touches the card
    device = resolve_device(args.device)
    cfg = get_preset(args.preset, parse_overrides(args.cfg_options))
    model = build_model(cfg, device=device)
    model.load_state_dict(_load_params(args.checkpoint, cfg, model))
    model.eval()
    radar_fn = (_try_radar_fn(cfg)
                if cfg.model.head.with_radar_fusion else None)

    report = compare_outputs(cfg, model, args.reference_npz,
                             radar_fn=radar_fn, box_tol=args.box_tol,
                             score_tol=args.score_tol, top_k=args.top_k,
                             num_det_slack=args.num_det_slack)
    if args.report_out:
        with open(args.report_out, "w") as f:
            json.dump(report, f, indent=2)
    print(f"samples: {report['n_samples']}  "
          f"rows compared: {report['compared_rows']}  "
          f"box max |Δ|: {report['box_max_abs']:.5f} (tol {args.box_tol})  "
          f"score max |Δ|: {report['score_max_abs']:.5f} "
          f"(tol {args.score_tol})  "
          f"label agreement: {report['label_agree_min']:.3f}  "
          f"num_det max |Δ|: {report['num_det_diff_max']}")
    print("PARITY " + ("PASSED" if report["passed"] else "FAILED"))
    return 0 if report["passed"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
