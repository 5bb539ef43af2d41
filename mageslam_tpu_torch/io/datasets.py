"""Standard SLAM dataset loaders: EuRoC MAV and TUM RGB-D.

Port of ``mageslam_tpu/io/datasets.py`` over the port's
``CameraCalibration``.  It reads EuRoC's ``sensor.yaml`` with its own
subset parser only (flat keys, scalars and one-line lists), which yields
the same fields as PyYAML on those files, and sizes a flat directory's
images from their headers, so it needs neither PyYAML nor PIL.

The reference's golden path drives frames from OpenCV VideoCapture
(Apps/Console/console.cpp:296-313) and carries calibration through
mage::Device camera models (Device/CameraCalibration.h:17-89).  Here the
equivalent input layer parses the two benchmark formats BASELINE.json's
north star is pinned to (EuRoC MH01 monocular; TUM sequences):

- EuRoC ASL layout: ``mav0/cam0/{data.csv,sensor.yaml,data/*.png}``,
  IMU ``mav0/imu0/data.csv``, ground truth
  ``mav0/state_groundtruth_estimate0/data.csv``.
- TUM RGB-D layout: ``rgb.txt`` (+ ``groundtruth.txt``, optional
  ``accelerometer.txt``), standard freiburg1/2/3 intrinsics if no
  calibration file is present.

Everything is returned as a ``DatasetSequence`` — image paths +
timestamps + a CameraCalibration scaled to the tracking resolution +
optional ground-truth view poses (for ATE via io/evaluation.py) and IMU
samples (for fuser/samples.py).
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np

from mageslam_tpu_torch.geometry.camera import CameraCalibration
from mageslam_tpu_torch.io.native_loader import image_size, scan_dataset

# standard TUM RGB-D intrinsics per sequence family (640x480), from the
# benchmark's published calibration tables
_TUM_INTRINSICS = {
    "freiburg1": (517.3, 516.5, 318.6, 255.3, 0.2624, -0.9531, -0.0054,
                  0.0026, 1.1633),
    "freiburg2": (520.9, 521.0, 325.1, 249.7, 0.2312, -0.7849, -0.0033,
                  -0.0001, 0.9172),
    "freiburg3": (535.4, 539.2, 320.1, 247.6, 0.0, 0.0, 0.0, 0.0, 0.0),
}


class ImuRecord(NamedTuple):
    timestamps: np.ndarray   # (N,) float64 seconds
    gyro: np.ndarray         # (N, 3) rad/s
    accel: np.ndarray        # (N, 3) m/s^2


class DatasetSequence(NamedTuple):
    name: str
    image_paths: list
    timestamps: np.ndarray               # (N,) float64 seconds
    calibration: CameraCalibration       # at native resolution
    gt_timestamps: Optional[np.ndarray]  # (M,) float64 seconds
    gt_view_poses: Optional[np.ndarray]  # (M, 7) quat+t view (world->cam)
    imu: Optional[ImuRecord]

    def tracking_calibration(self, width: int = 320,
                             height: int = 0) -> CameraCalibration:
        """Calibration scaled to the tracking resolution (reference
        resizes to width 320, console.cpp:70; MageSettings.h:336)."""
        if height <= 0:
            height = int(round(self.calibration.height * width
                               / self.calibration.width))
        return self.calibration.scaled(width / self.calibration.width,
                                       height / self.calibration.height)

    def gt_for_frames(self) -> Optional[np.ndarray]:
        """Ground-truth view pose per image frame (nearest-timestamp
        association), or None."""
        if self.gt_view_poses is None or not len(self.gt_view_poses):
            return None
        idx = np.searchsorted(self.gt_timestamps, self.timestamps)
        idx = np.clip(idx, 1, len(self.gt_timestamps) - 1)
        left = self.gt_timestamps[idx - 1]
        right = self.gt_timestamps[idx]
        idx = np.where(np.abs(self.timestamps - left)
                       < np.abs(self.timestamps - right), idx - 1, idx)
        return self.gt_view_poses[idx]


# ---------------------------------------------------------------------------
# small YAML-subset reader: EuRoC sensor.yaml files are flat and simple
def _read_yaml(path: Path) -> dict:
    out: dict = {}
    for line in path.read_text().splitlines():
        line = line.split("#", 1)[0].rstrip()
        if ":" not in line or line.startswith(" "):
            continue
        key, val = line.split(":", 1)
        val = val.strip()
        if val.startswith("[") and val.endswith("]"):
            try:
                out[key.strip()] = [float(v) for v in
                                    val[1:-1].split(",") if v.strip()]
            except ValueError:
                out[key.strip()] = val
        else:
            out[key.strip()] = val
    return out


def _pose_tq_to_view(t: np.ndarray, q_wxyz: np.ndarray) -> np.ndarray:
    """(N,3) positions + (N,4) w-x-y-z body->world quaternions -> (N,7)
    view poses in this repo's layout (quat W-FIRST + translation,
    world->camera)."""
    w, x, y, z = q_wxyz.T
    # conjugate = world->body rotation (vector part negated)
    xx, yy, zz, ww = -x, -y, -z, w
    R = np.stack([
        1 - 2 * (yy**2 + zz**2), 2 * (xx * yy - ww * zz),
        2 * (xx * zz + ww * yy),
        2 * (xx * yy + ww * zz), 1 - 2 * (xx**2 + zz**2),
        2 * (yy * zz - ww * xx),
        2 * (xx * zz - ww * yy), 2 * (yy * zz + ww * xx),
        1 - 2 * (xx**2 + yy**2),
    ], -1).reshape(-1, 3, 3)
    tv = -np.einsum("nij,nj->ni", R, t)
    qv = np.stack([ww, xx, yy, zz], -1)   # w-first, repo convention
    return np.concatenate([qv, tv], -1).astype(np.float32)


# ---------------------------------------------------------------------------
def load_euroc(root: str, cam: str = "cam0",
               max_frames: int = 0) -> DatasetSequence:
    """Load a EuRoC ASL sequence directory (the one containing ``mav0``,
    or ``mav0`` itself)."""
    root_p = Path(root)
    mav = root_p / "mav0" if (root_p / "mav0").is_dir() else root_p
    cam_dir = mav / cam
    if not cam_dir.is_dir():
        raise FileNotFoundError(f"no {cam} under {mav}")

    # frames
    stamps, paths = [], []
    data_csv = cam_dir / "data.csv"
    if data_csv.exists():
        with open(data_csv) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                p = cam_dir / "data" / row[1].strip()
                if p.exists():
                    stamps.append(int(row[0]) * 1e-9)
                    paths.append(str(p))
    else:
        for p in sorted((cam_dir / "data").iterdir()):
            if p.suffix.lower() == ".png":
                stamps.append(int(p.stem) * 1e-9)
                paths.append(str(p))
    if max_frames:
        stamps, paths = stamps[:max_frames], paths[:max_frames]

    # calibration (radial-tangential [k1 k2 p1 p2] -> Poly3K-ish; we carry
    # it in the OpenCV dist layout the camera model dispatch expects)
    cal = CameraCalibration.pinhole(458.654, 457.296, 367.215, 248.375,
                                    752, 480)
    y = _read_yaml(cam_dir / "sensor.yaml") if (cam_dir
                                                / "sensor.yaml").exists() \
        else {}
    if isinstance(y.get("intrinsics"), list) and len(y["intrinsics"]) >= 4:
        fu, fv, cu, cv = y["intrinsics"][:4]
        res = y.get("resolution", [752, 480])
        d = (y.get("distortion_coefficients") or [0, 0, 0, 0])[:4]
        cal = CameraCalibration.rational6k(
            fu, fv, cu, cv, d[0], d[1], d[2], d[3], 0, 0, 0, 0,
            int(res[0]), int(res[1]))

    # ground truth
    gt_ts = gt_poses = None
    gt_csv = mav / "state_groundtruth_estimate0" / "data.csv"
    if gt_csv.exists():
        rows = []
        with open(gt_csv) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                rows.append([float(v) for v in row[:8]])
        if rows:
            arr = np.asarray(rows)
            gt_ts = arr[:, 0] * 1e-9
            gt_poses = _pose_tq_to_view(arr[:, 1:4], arr[:, 4:8])

    # IMU
    imu = None
    imu_csv = mav / "imu0" / "data.csv"
    if imu_csv.exists():
        rows = []
        with open(imu_csv) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                rows.append([float(v) for v in row[:7]])
        if rows:
            arr = np.asarray(rows)
            imu = ImuRecord(arr[:, 0] * 1e-9, arr[:, 1:4], arr[:, 4:7])

    return DatasetSequence(root_p.name or "euroc", paths,
                           np.asarray(stamps), cal, gt_ts, gt_poses, imu)


# ---------------------------------------------------------------------------
def load_tum_rgbd(root: str, max_frames: int = 0) -> DatasetSequence:
    """Load a TUM RGB-D sequence directory (contains ``rgb.txt``)."""
    root_p = Path(root)
    rgb_txt = root_p / "rgb.txt"
    if not rgb_txt.exists():
        raise FileNotFoundError(f"no rgb.txt under {root_p}")

    stamps, paths = [], []
    for line in rgb_txt.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        ts, rel = line.split()[:2]
        p = root_p / rel
        if p.exists():
            stamps.append(float(ts))
            paths.append(str(p))
    if max_frames:
        stamps, paths = stamps[:max_frames], paths[:max_frames]

    fam = next((k for k in _TUM_INTRINSICS if k in root_p.name.lower()),
               "freiburg3")
    fx, fy, cx, cy, k1, k2, p1, p2, k3 = _TUM_INTRINSICS[fam]
    if any((k1, k2, p1, p2, k3)):
        cal = CameraCalibration.rational6k(fx, fy, cx, cy, k1, k2, p1, p2,
                                           k3, 0, 0, 0, 640, 480)
    else:
        cal = CameraCalibration.pinhole(fx, fy, cx, cy, 640, 480)

    gt_ts = gt_poses = None
    gt_txt = root_p / "groundtruth.txt"
    if gt_txt.exists():
        rows = []
        for line in gt_txt.read_text().splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.split()[:8]]
            if len(vals) == 8:
                rows.append(vals)
        if rows:
            arr = np.asarray(rows)
            gt_ts = arr[:, 0]
            # TUM ground truth is tx ty tz qx qy qz qw (body->world)
            q_wxyz = arr[:, [7, 4, 5, 6]]
            gt_poses = _pose_tq_to_view(arr[:, 1:4], q_wxyz)

    return DatasetSequence(root_p.name or "tum", paths,
                           np.asarray(stamps), cal, gt_ts, gt_poses, None)


def load_dataset(root: str, max_frames: int = 0) -> DatasetSequence:
    """Autodetect EuRoC vs TUM vs flat image directory."""
    root_p = Path(root)
    if (root_p / "mav0").is_dir() or (root_p / "cam0").is_dir():
        return load_euroc(root, max_frames=max_frames)
    if (root_p / "rgb.txt").exists():
        return load_tum_rgbd(root, max_frames=max_frames)
    # flat directory of images, identity-ish pinhole guess
    paths = scan_dataset(root)
    if not paths:
        raise FileNotFoundError(f"no dataset recognized at {root}")
    if max_frames:
        paths = paths[:max_frames]
    w, h = image_size(paths[0])
    cal = CameraCalibration.pinhole(0.85 * w, 0.85 * w, w / 2, h / 2, w, h)
    ts = np.arange(len(paths), dtype=np.float64) / 30.0
    return DatasetSequence(root_p.name, paths, ts, cal, None, None, None)
