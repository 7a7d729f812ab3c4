"""Data preparation CLI (tools/create_data.py nuscenes analog;
``transcar_tpu/cli/create_data.py``).  Host only: it needs no device.

Walks the raw nuScenes dataset with the devkit and writes
``nuscenes_infos_{train,val}.pkl`` (or ``_test.pkl``) in the same schema the
reference's converter produces (tools/data_converter/nuscenes_converter.py):

  per sample: lidar_path, token, timestamp, lidar2ego_* and ego2global_*
  poses, up-to-``max_sweeps`` lidar sweeps, per-camera
  sensor2lidar rotation/translation + intrinsics (obtain_sensor2top
  semantics: sweep→ego→global→ego'→lidar chained transform, :287-347),
  gt boxes as (x, y, z_gravity, w, l, h, −yaw−π/2) in the lidar frame,
  lidar-frame velocities, valid_flag = num_lidar_pts + num_radar_pts > 0.

The infos walk and ``--with-2d-anno`` import the ``nuscenes`` devkit and
``pyquaternion`` inside the functions that need them;
``--cache-radar-tokens`` alone runs without either (``data/radar_io.py``
reads the nuScenes tables).

Usage:
    python -m transcar_tpu_torch.cli.create_data nuscenes \
        --root-path data/nuscenes --version v1.0-trainval --max-sweeps 10
        [--with-2d-anno] [--cache-radar-tokens]
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np


def _sensor2top(nusc, sensor_token, l2e_t, l2e_r_mat, e2g_t, e2g_r_mat,
                sensor_type, quat_to_rot):
    sd = nusc.get("sample_data", sensor_token)
    cs = nusc.get("calibrated_sensor", sd["calibrated_sensor_token"])
    pose = nusc.get("ego_pose", sd["ego_pose_token"])
    data_path = str(nusc.get_sample_data_path(sd["token"]))
    l2e_r_s_mat = quat_to_rot(cs["rotation"])
    e2g_r_s_mat = quat_to_rot(pose["rotation"])
    l2e_t_s = np.asarray(cs["translation"])
    e2g_t_s = np.asarray(pose["translation"])

    inv_chain = (np.linalg.inv(e2g_r_mat).T @ np.linalg.inv(l2e_r_mat).T)
    r = (l2e_r_s_mat.T @ e2g_r_s_mat.T) @ inv_chain
    t = (l2e_t_s @ e2g_r_s_mat.T + e2g_t_s) @ inv_chain
    t -= (np.asarray(e2g_t) @ inv_chain
          + np.asarray(l2e_t) @ np.linalg.inv(l2e_r_mat).T)
    return {
        "data_path": data_path,
        "type": sensor_type,
        "sample_data_token": sd["token"],
        "sensor2ego_translation": cs["translation"],
        "sensor2ego_rotation": cs["rotation"],
        "ego2global_translation": pose["translation"],
        "ego2global_rotation": pose["rotation"],
        "timestamp": sd["timestamp"],
        "sensor2lidar_rotation": r.T,
        "sensor2lidar_translation": t,
    }


def create_nuscenes_infos(root_path: str, version: str = "v1.0-trainval",
                          max_sweeps: int = 10, out_dir=None):
    from nuscenes import NuScenes
    from nuscenes.utils import splits
    from pyquaternion import Quaternion

    def quat_to_rot(q):
        return Quaternion(q).rotation_matrix

    nusc = NuScenes(version=version, dataroot=root_path, verbose=True)
    test = "test" in version
    if version == "v1.0-trainval":
        train_scenes, val_scenes = splits.train, splits.val
    elif version == "v1.0-test":
        train_scenes, val_scenes = splits.test, []
    elif version == "v1.0-mini":
        train_scenes, val_scenes = splits.mini_train, splits.mini_val
    else:
        raise ValueError(f"unknown version {version}")
    scene_name_to_token = {s["name"]: s["token"] for s in nusc.scene}
    train_tokens = {scene_name_to_token[n] for n in train_scenes
                    if n in scene_name_to_token}

    from transcar_tpu_torch.data.infos import NAME_MAPPING

    cam_types = ("CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT",
                 "CAM_BACK", "CAM_BACK_LEFT", "CAM_BACK_RIGHT")
    train_infos, val_infos = [], []
    for sample in nusc.sample:
        lidar_token = sample["data"]["LIDAR_TOP"]
        sd = nusc.get("sample_data", lidar_token)
        cs = nusc.get("calibrated_sensor", sd["calibrated_sensor_token"])
        pose = nusc.get("ego_pose", sd["ego_pose_token"])
        lidar_path, boxes, _ = nusc.get_sample_data(lidar_token)

        info = {
            "lidar_path": str(lidar_path),
            "token": sample["token"],
            "sweeps": [],
            "cams": {},
            "lidar2ego_translation": cs["translation"],
            "lidar2ego_rotation": cs["rotation"],
            "ego2global_translation": pose["translation"],
            "ego2global_rotation": pose["rotation"],
            "timestamp": sample["timestamp"],
        }
        l2e_r_mat = quat_to_rot(cs["rotation"])
        e2g_r_mat = quat_to_rot(pose["rotation"])
        for cam in cam_types:
            cam_token = sample["data"][cam]
            _, _, intrinsic = nusc.get_sample_data(cam_token)
            cam_info = _sensor2top(nusc, cam_token, cs["translation"],
                                   l2e_r_mat, pose["translation"],
                                   e2g_r_mat, cam, quat_to_rot)
            cam_info["cam_intrinsic"] = intrinsic
            info["cams"][cam] = cam_info

        sweep_rec = sd
        while len(info["sweeps"]) < max_sweeps and sweep_rec["prev"]:
            info["sweeps"].append(
                _sensor2top(nusc, sweep_rec["prev"], cs["translation"],
                            l2e_r_mat, pose["translation"], e2g_r_mat,
                            "lidar", quat_to_rot))
            sweep_rec = nusc.get("sample_data", sweep_rec["prev"])

        if not test:
            annos = [nusc.get("sample_annotation", t)
                     for t in sample["anns"]]
            locs = np.array([b.center for b in boxes]).reshape(-1, 3)
            dims = np.array([b.wlh for b in boxes]).reshape(-1, 3)
            rots = np.array([b.orientation.yaw_pitch_roll[0]
                             for b in boxes]).reshape(-1, 1)
            velocity = np.array([nusc.box_velocity(t)[:2]
                                 for t in sample["anns"]]).reshape(-1, 2)
            inv = np.linalg.inv(e2g_r_mat).T @ np.linalg.inv(l2e_r_mat).T
            for i in range(len(boxes)):
                v = np.array([*velocity[i], 0.0]) @ inv
                velocity[i] = v[:2]
            names = np.array([NAME_MAPPING.get(b.name, b.name)
                              for b in boxes])
            info["gt_boxes"] = np.concatenate(
                [locs, dims, -rots - np.pi / 2], axis=1)
            info["gt_names"] = names
            info["gt_velocity"] = velocity
            info["num_lidar_pts"] = np.array(
                [a["num_lidar_pts"] for a in annos])
            info["num_radar_pts"] = np.array(
                [a["num_radar_pts"] for a in annos])
            info["valid_flag"] = np.array(
                [(a["num_lidar_pts"] + a["num_radar_pts"]) > 0
                 for a in annos], dtype=bool)
            # GT attribute names ('' when unannotated) — extension over
            # the reference pkl schema: lets eval/metrics.py compute the
            # AAE term without the raw dataset (devkit load_gt reads the
            # same attribute_tokens)
            info["gt_attrs"] = [
                nusc.get("attribute", a["attribute_tokens"][0])["name"]
                if a["attribute_tokens"] else "" for a in annos]

        if sample["scene_token"] in train_tokens:
            train_infos.append(info)
        else:
            val_infos.append(info)

    out_dir = out_dir or root_path
    meta = {"version": version}
    if test:
        _dump(out_dir, "nuscenes_infos_test.pkl", train_infos, meta)
    else:
        _dump(out_dir, "nuscenes_infos_train.pkl", train_infos, meta)
        _dump(out_dir, "nuscenes_infos_val.pkl", val_infos, meta)


def _dump(out_dir, name, infos, meta):
    path = os.path.join(out_dir, name)
    with open(path, "wb") as f:
        pickle.dump({"infos": infos, "metadata": meta}, f)
    print(f"wrote {len(infos)} infos to {path}")


def export_2d_annotations(root_path: str, version: str, out_dir: str):
    """coco-json 2D annotation export for every split's infos pkl
    (reference create_data.py:70-80 → nuscenes_converter.py:348-410)."""
    from nuscenes import NuScenes

    from transcar_tpu_torch.data.export2d import export_2d_annotation

    nusc = NuScenes(version=version, dataroot=root_path, verbose=True)
    splits = (["test"] if "test" in version else ["train", "val"])
    for split in splits:
        info_path = os.path.join(out_dir, f"nuscenes_infos_{split}.pkl")
        if os.path.exists(info_path):
            export_2d_annotation(nusc, info_path)
        else:
            print(f"skip 2d-anno export: {info_path} missing")


def cache_radar_tokens(root_path: str, version: str,
                       nsweeps: int = 5, num_tokens: int = 1500) -> str:
    """Precompute the per-sample radar token cache the training loader
    reads (cli/train.py ``_try_radar_fn`` layout), through the
    devkit-free ingestion (data/radar_io.py) — the reference instead
    re-reads + re-featurizes the .pcd files inside every forward
    (detr3d_head.py:301-536)."""
    import numpy as np
    from transcar_tpu_torch.data.radar import load_radar_tokens
    from transcar_tpu_torch.data.radar_io import NuScenesTables

    nusc = NuScenesTables(root_path, version=version)
    cache_dir = os.path.join(root_path, "radar_token_cache",
                             f"{nsweeps}sweep_{num_tokens}")
    os.makedirs(cache_dir, exist_ok=True)
    done = 0
    for token in nusc.tokens("sample"):
        path = os.path.join(cache_dir, f"{token}.npy")
        if not os.path.exists(path):
            np.save(path, load_radar_tokens(nusc, token, nsweeps=nsweeps,
                                            num_tokens=num_tokens))
        done += 1
    print(f"radar token cache: {done} samples → {cache_dir}")
    return cache_dir


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("dataset", choices=["nuscenes"])
    ap.add_argument("--root-path", default="data/nuscenes")
    ap.add_argument("--version", default="v1.0-trainval")
    ap.add_argument("--max-sweeps", type=int, default=10)
    ap.add_argument("--out-dir")
    ap.add_argument("--with-2d-anno", action="store_true",
                    help="also export coco-style 2D annotations "
                         "(reference create_data.py:70-80)")
    ap.add_argument("--cache-radar-tokens", action="store_true",
                    help="precompute the [num_tokens, 36] radar buffer "
                         "per sample (devkit-free; training/eval then "
                         "read the cache instead of the .pcd files)")
    ap.add_argument("--radar-sweeps", type=int, default=5)
    ap.add_argument("--radar-tokens", type=int, default=1500)
    args = ap.parse_args(argv)
    create_nuscenes_infos(args.root_path, args.version, args.max_sweeps,
                          args.out_dir)
    if args.with_2d_anno:
        export_2d_annotations(args.root_path, args.version,
                              args.out_dir or args.root_path)
    if args.cache_radar_tokens:
        cache_radar_tokens(args.root_path, args.version,
                           args.radar_sweeps, args.radar_tokens)


if __name__ == "__main__":
    main()
