"""COLMAP scene (port of gscodec_studio_tpu/datasets/colmap.py): ``Parser``
(the sparse model, normalised, with its intrinsics and scene scale),
``Dataset`` (the train or validation views, each an image, K, c2w and, on
request, the view's SfM depth tracks) and ``GSCDataset`` (the split by
explicit test-view ids).

The one difference is image I/O, since the card machine has no imageio,
cv2 or PIL: PNGs are read by the port's own reader
(compression/png_io.read_png), other formats through imageio where it
imports; an integer-factor downscale is the port's own box average, bit
for bit cv2.INTER_AREA on uint8 (``area_downscale``). Undistortion and a
resize by a non-integer factor need cv2 and raise, naming the camera model
or the sizes, where it does not import.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

from gscodec_studio_tpu_torch.compression.png_io import read_png
from gscodec_studio_tpu_torch.datasets import colmap_io
from gscodec_studio_tpu_torch.datasets.normalize import normalize_world


class Parser:
    """Loads a COLMAP scene: camtoworlds [N,4,4], Ks_dict, image paths,
    3D points (+rgb), normalization, scene_scale."""

    def __init__(
        self,
        data_dir: str,
        factor: int = 1,
        normalize: bool = True,
        test_every: int = 8,
        load_points2d: bool = False,
    ):
        self.data_dir = data_dir
        self.factor = factor
        self.test_every = test_every

        sparse = os.path.join(data_dir, "sparse", "0")
        if not os.path.exists(sparse):
            sparse = os.path.join(data_dir, "sparse")
        cams, images, (points, points_rgb, points_err, point_ids) = (
            colmap_io.read_model(sparse, load_points2d=load_points2d)
        )

        # sorted by file name, for a deterministic order
        ordered = sorted(images.values(), key=lambda im: im.name)
        w2c = []
        camera_ids = []
        image_names = []
        for im in ordered:
            mat = np.eye(4)
            mat[:3, :3] = colmap_io.qvec_to_rotmat(im.qvec)
            mat[:3, 3] = im.tvec
            w2c.append(mat)
            camera_ids.append(im.camera_id)
            image_names.append(im.name)
        camtoworlds = np.linalg.inv(np.stack(w2c))

        # intrinsics divided by the factor; distortion kept for undistortion
        self.Ks_dict: Dict[int, np.ndarray] = {}
        self.imsize_dict: Dict[int, tuple] = {}
        self.dist_dict: Dict[int, np.ndarray] = {}
        self.model_dict: Dict[int, str] = {}
        for cam_id, cam in cams.items():
            fx, fy, cx, cy, dist = _intrinsics_from_colmap(cam)
            K = np.array(
                [[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=np.float64
            )
            K[:2] /= factor
            self.Ks_dict[cam_id] = K
            self.imsize_dict[cam_id] = (
                int(round(cam.width / factor)),
                int(round(cam.height / factor)),
            )
            self.dist_dict[cam_id] = dist
            self.model_dict[cam_id] = cam.model

        # images_<factor>/ holds the downscaled images where it exists
        image_dir = os.path.join(data_dir, "images")
        if factor > 1 and os.path.exists(image_dir + f"_{factor}"):
            image_dir = image_dir + f"_{factor}"
        self.image_dir = image_dir
        self.image_names = image_names
        self.image_paths = [os.path.join(image_dir, n) for n in image_names]
        self.camera_ids = camera_ids

        if normalize:
            camtoworlds, points, self.transform = normalize_world(
                camtoworlds, points
            )
        else:
            self.transform = np.eye(4)

        self.camtoworlds = camtoworlds.astype(np.float32)
        self.points = points.astype(np.float32)
        self.points_rgb = points_rgb
        self.points_err = points_err

        # image name -> rows of self.points that the image tracks (SfM
        # depth supervision)
        self.point_indices: Dict[str, np.ndarray] = {}
        if load_points2d:
            id_to_row = {int(pid): i for i, pid in enumerate(point_ids)}
            for im in ordered:
                if im.point3d_ids is None:
                    continue
                rows = [
                    id_to_row[int(pid)]
                    for pid in im.point3d_ids
                    if pid >= 0 and int(pid) in id_to_row
                ]
                self.point_indices[im.name] = np.asarray(rows, np.int64)

        # scene scale: 1.1 x the largest camera distance from their mean
        camera_locs = self.camtoworlds[:, :3, 3]
        scene_center = camera_locs.mean(axis=0)
        self.scene_scale = float(
            np.max(np.linalg.norm(camera_locs - scene_center, axis=1)) * 1.1
        )


def _intrinsics_from_colmap(cam: colmap_io.ColmapCamera):
    p = cam.params
    model = cam.model
    dist = np.zeros(4)
    if model == "SIMPLE_PINHOLE":
        fx = fy = p[0]
        cx, cy = p[1], p[2]
    elif model == "PINHOLE":
        fx, fy, cx, cy = p[:4]
    elif model == "SIMPLE_RADIAL":
        fx = fy = p[0]
        cx, cy = p[1], p[2]
        dist = np.array([p[3], 0, 0, 0])
    elif model == "RADIAL":
        fx = fy = p[0]
        cx, cy = p[1], p[2]
        dist = np.array([p[3], p[4], 0, 0])
    elif model in ("OPENCV", "OPENCV_FISHEYE"):
        fx, fy, cx, cy = p[:4]
        dist = p[4:8]
    else:
        raise ValueError(f"unsupported camera model {model}")
    return fx, fy, cx, cy, dist


def read_image(path: str) -> np.ndarray:
    """uint8 [H, W, 3] (a gray image repeated, alpha dropped). PNGs through
    the port's reader; other formats need imageio."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        image = read_png(path)
    else:
        try:
            import imageio.v2 as imageio
        except ImportError as e:
            raise RuntimeError(
                f"{path}: a {ext or 'extensionless'} image needs imageio, "
                f"which does not import here; the port reads PNG itself"
            ) from e
        image = np.asarray(imageio.imread(path))
    if image.ndim == 2:
        image = np.repeat(image[..., None], 3, axis=-1)
    return image[..., :3]


def area_downscale(image: np.ndarray, k: int) -> np.ndarray:
    """uint8 [H, W, C] -> [H/k, W/k, C], each pixel the mean of its k x k
    block, rounded as cv2.resize(..., INTER_AREA) rounds on uint8: half up
    at k = 2 (its vector path, (sum + 2) >> 2), else the float32 product
    sum * (1/k^2) rounded half to even. H and W must be multiples of k."""
    h, w = image.shape[:2]
    if h % k or w % k:
        raise ValueError(f"{w}x{h} is no multiple of the factor {k}")
    s = image.reshape(h // k, k, w // k, k, -1).astype(np.int32).sum((1, 3))
    if k == 2:
        out = (s + 2) >> 2
    else:
        out = np.rint(s.astype(np.float32) * np.float32(1.0 / (k * k)))
    return out.astype(np.uint8).reshape((h // k, w // k) + image.shape[2:])


def _resize(image: np.ndarray, size, path: str) -> np.ndarray:
    """``image`` at ``size`` (w, h): an integer-factor downscale by
    area_downscale, any other size through cv2's INTER_AREA."""
    h, w = image.shape[:2]
    exp_w, exp_h = size
    k = w // exp_w
    if k >= 1 and w == k * exp_w and h == k * exp_h:
        return area_downscale(image, k)
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            f"{path}: resizing {w}x{h} to {exp_w}x{exp_h} is no integer "
            f"factor and needs cv2, which does not import here"
        ) from e
    return cv2.resize(image, (exp_w, exp_h), interpolation=cv2.INTER_AREA)


def _undistort(image, K, dist, model: str, size, path: str):
    """(image, K) undistorted through cv2 (OpenCV's radial-tangential or
    fisheye model)."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            f"{path}: the {model} camera has distortion {list(dist)}, whose "
            f"undistortion needs cv2, which does not import here"
        ) from e
    w, h = size
    if model == "OPENCV_FISHEYE":
        newK = K.copy()
        mapx, mapy = cv2.fisheye.initUndistortRectifyMap(
            K, dist, np.eye(3), newK, (w, h), cv2.CV_32FC1
        )
    else:
        d5 = np.array([dist[0], dist[1], dist[2], dist[3], 0.0])
        newK, _ = cv2.getOptimalNewCameraMatrix(K, d5, (w, h), 0)
        mapx, mapy = cv2.initUndistortRectifyMap(
            K, d5, None, newK, (w, h), cv2.CV_32FC1
        )
    return cv2.remap(image, mapx, mapy, cv2.INTER_LINEAR), newK


class Dataset:
    """The train (every view but each ``test_every``-th) or validation
    views of a Parser, as dicts of K, camtoworld, image [H, W, 3] in
    [0, 1], image_id and, with ``load_depths``, the view's SfM tracks
    projected into it: points [M, 2] (pixel xy) and depths [M]."""

    def __init__(
        self,
        parser: Parser,
        split: str = "train",
        patch_size: Optional[int] = None,
        load_depths: bool = False,
    ):
        self.parser = parser
        self.split = split
        self.patch_size = patch_size
        self.load_depths = load_depths
        indices = np.arange(len(parser.image_paths))
        if split == "train":
            self.indices = indices[indices % parser.test_every != 0]
        else:
            self.indices = indices[indices % parser.test_every == 0]

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, item: int) -> Dict:
        idx = int(self.indices[item])
        p = self.parser
        path = p.image_paths[idx]
        image = read_image(path)
        cam_id = p.camera_ids[idx]
        K = p.Ks_dict[cam_id].copy()
        # K is divided by the factor; an image read from the full-size
        # images/ (no images_<factor>/) is resized to match it
        size = p.imsize_dict[cam_id]
        if (image.shape[1], image.shape[0]) != size:
            image = _resize(image, size, path)
        dist = p.dist_dict[cam_id]
        if np.any(dist != 0):
            image, K = _undistort(image, K, dist, p.model_dict[cam_id],
                                  size, path)

        data = {
            "K": K.astype(np.float32),
            "camtoworld": p.camtoworlds[idx],
            "image": image.astype(np.float32) / 255.0,
            "image_id": idx,
        }
        if self.load_depths:
            # this image's SfM tracks in the (undistorted, factor-scaled)
            # camera: pixel xy and depth
            name = p.image_names[idx]
            rows = p.point_indices.get(name, np.empty(0, np.int64))
            pts_world = p.points[rows]  # [M, 3]
            w2c = np.linalg.inv(p.camtoworlds[idx])
            cam = (pts_world @ w2c[:3, :3].T) + w2c[:3, 3]
            depths = cam[:, 2]
            uvw = cam @ K.T
            xy = uvw[:, :2] / np.maximum(uvw[:, 2:3], 1e-8)
            h, w = data["image"].shape[:2]
            keep = (
                (depths > 0.0)
                & (xy[:, 0] >= 0) & (xy[:, 0] < w)
                & (xy[:, 1] >= 0) & (xy[:, 1] < h)
            )
            data["points"] = xy[keep].astype(np.float32)  # [M, 2]
            data["depths"] = depths[keep].astype(np.float32)  # [M]
        return data


class GSCDataset(Dataset):
    """The split by explicit test-view ids (the MPEG GSC evaluation
    convention): ``test_view_ids`` are the validation views, the rest
    train."""

    def __init__(self, parser: Parser, split: str = "train",
                 test_view_ids: Sequence[int] = (0,), **kw):
        super().__init__(parser, split="train", **kw)
        all_idx = np.arange(len(parser.image_paths))
        test = np.asarray(sorted(test_view_ids))
        if split == "train":
            self.indices = np.setdiff1d(all_idx, test)
        else:
            self.indices = test
