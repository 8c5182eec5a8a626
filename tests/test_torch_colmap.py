"""gscodec_studio_tpu_torch's COLMAP loader and trajectories against the
JAX package on the CPU: tiny COLMAP models written here in text and binary
(SIMPLE_PINHOLE, PINHOLE, SIMPLE_RADIAL and OPENCV cameras, small PNGs,
2D tracks), read by both packages.

Tolerances:
  * Parser fields (camtoworlds, Ks_dict, points, points_rgb, transform,
    scene_scale, point_indices, image sizes and names): bit for bit (the
    same float64 numpy on the same bytes);
  * Dataset items on undistorted cameras (image, K, camtoworld and the
    depth tracks): bit for bit; images_2/ read as they are, and the
    factor-2 downscale from images/, bit for bit cv2.INTER_AREA (which the
    JAX package calls); undistorted images (through cv2 in both) within
    1/255;
  * GSCDataset's splits: equal;
  * the interpolated, ellipse and spiral paths: 1e-6.
"""

import builtins
import os
import struct

import numpy as np
import pytest

from gscodec_studio_tpu.datasets import colmap as jcolmap
from gscodec_studio_tpu.datasets import traj as jtraj
from gscodec_studio_tpu_torch.compression.png_io import write_png
from gscodec_studio_tpu_torch.datasets import colmap as tcolmap
from gscodec_studio_tpu_torch.datasets import traj as ttraj

# COLMAP model name -> (id, parameters at a 32 x 24 image)
MODELS = {
    "SIMPLE_PINHOLE": (0, [30.0, 16.0, 12.0]),
    "PINHOLE": (1, [30.0, 29.0, 15.5, 12.5]),
    "SIMPLE_RADIAL": (2, [30.0, 16.0, 12.0, 0.05]),
    "OPENCV": (4, [30.0, 29.5, 16.0, 11.5, 0.04, -0.01, 0.001, 0.002]),
}


def rotmat_to_qvec(R):
    """Rotation matrix -> COLMAP's (w, x, y, z) with w >= 0."""
    w = np.sqrt(max(0.0, 1.0 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
    x = np.sqrt(max(0.0, 1.0 + R[0, 0] - R[1, 1] - R[2, 2])) / 2
    y = np.sqrt(max(0.0, 1.0 - R[0, 0] + R[1, 1] - R[2, 2])) / 2
    z = np.sqrt(max(0.0, 1.0 - R[0, 0] - R[1, 1] + R[2, 2])) / 2
    x = np.copysign(x, R[2, 1] - R[1, 2])
    y = np.copysign(y, R[0, 2] - R[2, 0])
    z = np.copysign(z, R[1, 0] - R[0, 1])
    return np.array([w, x, y, z])


def look_at_w2c(eye, target=np.zeros(3)):
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(np.array([0.0, -1.0, 0.0]), fwd)
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])  # world -> camera rows
    return R, -R @ eye


def make_scene(rng, n_images=9, n_points=60, width=32, height=24,
               models=tuple(MODELS)):
    """A ring of cameras around random points: (cameras, images, points)
    with each image's 2D tracks (the points it sees, and one without a
    3D point)."""
    cams = []
    for i, name in enumerate(models):
        mid, params = MODELS[name]
        s = width / 32.0
        params = [p * s if j < (3 if mid in (0, 2) else 4) else p
                  for j, p in enumerate(params)]
        cams.append(dict(id=i + 1, model=name, model_id=mid, width=width,
                         height=height, params=params))
    xyz = rng.normal(0, 0.6, (n_points, 3))
    rgb = rng.integers(0, 256, (n_points, 3))
    err = rng.random(n_points)
    pids = np.arange(1, n_points + 1) * 3  # COLMAP ids need not be rows
    images = []
    for i in range(n_images):
        ang = 2 * np.pi * i / n_images
        eye = np.array([4 * np.sin(ang), -0.5 + 0.1 * i, -4 * np.cos(ang)])
        R, t = look_at_w2c(eye)
        cam = cams[i % len(cams)]
        p = cam["params"]
        fx, fy, cx, cy = ((p[0], p[0], p[1], p[2]) if cam["model_id"] in (0, 2)
                          else p[:4])
        pc = xyz @ R.T + t
        uv = np.stack([fx * pc[:, 0] / pc[:, 2] + cx,
                       fy * pc[:, 1] / pc[:, 2] + cy], -1)
        seen = np.nonzero((pc[:, 2] > 0) & (uv[:, 0] >= 0)
                          & (uv[:, 0] < width) & (uv[:, 1] >= 0)
                          & (uv[:, 1] < height))[0]
        pts2d = [(uv[j, 0], uv[j, 1], int(pids[j])) for j in seen]
        pts2d.append((1.5, 2.5, -1))
        images.append(dict(id=i + 1, qvec=rotmat_to_qvec(R), tvec=t,
                           camera_id=cam["id"], name=f"view_{i:02d}.png",
                           points2d=pts2d))
    return cams, images, (pids, xyz, rgb, err)


def write_model(sparse, cams, images, points, binary):
    os.makedirs(sparse, exist_ok=True)
    pids, xyz, rgb, err = points
    tracks = {int(p): [] for p in pids}
    for im in images:
        for k, (_, _, pid) in enumerate(im["points2d"]):
            if pid >= 0:
                tracks[pid].append((im["id"], k))
    if binary:
        with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
            f.write(struct.pack("<Q", len(cams)))
            for c in cams:
                f.write(struct.pack("<iiQQ", c["id"], c["model_id"],
                                    c["width"], c["height"]))
                f.write(struct.pack(f"<{len(c['params'])}d", *c["params"]))
        with open(os.path.join(sparse, "images.bin"), "wb") as f:
            f.write(struct.pack("<Q", len(images)))
            for im in images:
                f.write(struct.pack("<i4d3di", im["id"], *im["qvec"],
                                    *im["tvec"], im["camera_id"]))
                f.write(im["name"].encode() + b"\x00")
                f.write(struct.pack("<Q", len(im["points2d"])))
                for x, y, pid in im["points2d"]:
                    f.write(struct.pack("<ddq", x, y, pid))
        with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
            f.write(struct.pack("<Q", len(pids)))
            for j, pid in enumerate(pids):
                f.write(struct.pack("<Q3d3Bd", int(pid), *xyz[j],
                                    *map(int, rgb[j]), err[j]))
                tr = tracks[int(pid)]
                f.write(struct.pack("<Q", len(tr)))
                for iid, k in tr:
                    f.write(struct.pack("<ii", iid, k))
        return
    with open(os.path.join(sparse, "cameras.txt"), "w") as f:
        f.write("# CAMERA_ID MODEL WIDTH HEIGHT PARAMS[]\n")
        for c in cams:
            f.write(f"{c['id']} {c['model']} {c['width']} {c['height']} "
                    + " ".join(repr(float(p)) for p in c["params"]) + "\n")
    with open(os.path.join(sparse, "images.txt"), "w") as f:
        f.write("# IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID NAME\n")
        for im in images:
            f.write(" ".join([str(im["id"])]
                             + [repr(float(v)) for v in im["qvec"]]
                             + [repr(float(v)) for v in im["tvec"]]
                             + [str(im["camera_id"]), im["name"]]) + "\n")
            f.write(" ".join(f"{float(x)!r} {float(y)!r} {pid}"
                             for x, y, pid in im["points2d"]) + "\n")
    with open(os.path.join(sparse, "points3D.txt"), "w") as f:
        for j, pid in enumerate(pids):
            tr = " ".join(f"{iid} {k}" for iid, k in tracks[int(pid)])
            f.write(f"{pid} " + " ".join(repr(float(v)) for v in xyz[j])
                    + f" {rgb[j][0]} {rgb[j][1]} {rgb[j][2]} "
                    f"{float(err[j])!r} {tr}\n")


def write_images(image_dir, images, width, height, rng):
    os.makedirs(image_dir, exist_ok=True)
    y, x = np.mgrid[0:height, 0:width]
    for i, im in enumerate(images):
        base = np.stack([np.sin(x / 5 + i), np.cos(y / 4 - i),
                         np.sin((x + y) / 7)], -1) * 90 + 128
        img = np.clip(base + rng.normal(0, 20, base.shape), 0, 255)
        write_png(os.path.join(image_dir, im["name"]), img.astype(np.uint8))


def write_colmap_dir(root, rng, binary=True, width=32, height=24,
                     models=tuple(MODELS), n_images=9, images_2=False):
    """A COLMAP directory: sparse/0 in text or binary, images/ and, with
    ``images_2``, images_2/ at half the size."""
    cams, images, points = make_scene(rng, n_images=n_images, width=width,
                                      height=height, models=models)
    write_model(os.path.join(root, "sparse", "0"), cams, images, points,
                binary)
    write_images(os.path.join(root, "images"), images, width, height, rng)
    if images_2:
        write_images(os.path.join(root, "images_2"), images, width // 2,
                     height // 2, rng)
    return root


@pytest.fixture(scope="module", params=["bin", "txt"])
def colmap_dir(request, tmp_path_factory):
    root = str(tmp_path_factory.mktemp(f"colmap_{request.param}"))
    return write_colmap_dir(root, np.random.default_rng(7),
                            binary=request.param == "bin")


def parsers(root, **kw):
    return jcolmap.Parser(root, **kw), tcolmap.Parser(root, **kw)


@pytest.mark.parametrize("factor", [1, 2])
def test_parser_fields_match_jax(colmap_dir, factor):
    jp, tp = parsers(colmap_dir, factor=factor, load_points2d=True)
    for k in ("camtoworlds", "points", "points_rgb", "points_err",
              "transform"):
        np.testing.assert_array_equal(getattr(tp, k), getattr(jp, k),
                                      err_msg=k)
        assert getattr(tp, k).dtype == getattr(jp, k).dtype, k
    assert tp.scene_scale == jp.scene_scale
    assert tp.image_names == jp.image_names and tp.camera_ids == jp.camera_ids
    assert tp.image_paths == jp.image_paths
    for d in ("Ks_dict", "imsize_dict", "dist_dict", "model_dict"):
        a, b = getattr(tp, d), getattr(jp, d)
        assert sorted(a) == sorted(b), d
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=d)
    assert sorted(tp.point_indices) == sorted(jp.point_indices)
    assert sum(len(v) for v in jp.point_indices.values()) > 20
    for k, v in jp.point_indices.items():
        np.testing.assert_array_equal(tp.point_indices[k], v)


def _items_equal(ti, ji, image_atol=0.0):
    assert sorted(ti) == sorted(ji)
    for k in ji:
        if k == "image" and image_atol:
            np.testing.assert_allclose(ti[k], ji[k], rtol=0, atol=image_atol)
        else:
            np.testing.assert_array_equal(np.asarray(ti[k]),
                                          np.asarray(ji[k]), err_msg=k)
        assert np.asarray(ti[k]).dtype == np.asarray(ji[k]).dtype, k


@pytest.mark.parametrize("split", ["train", "val"])
def test_dataset_items_match_jax(colmap_dir, split):
    jp, tp = parsers(colmap_dir, load_points2d=True)
    jd = jcolmap.Dataset(jp, split=split, load_depths=True)
    td = tcolmap.Dataset(tp, split=split, load_depths=True)
    np.testing.assert_array_equal(td.indices, jd.indices)
    n_tracks = 0
    for i in range(len(jd)):
        ji, ti = jd[i], td[i]
        distorted = np.any(jp.dist_dict[jp.camera_ids[int(jd.indices[i])]])
        _items_equal(ti, ji, image_atol=1 / 255 if distorted else 0.0)
        assert ti["image"].shape == (24, 32, 3)
        n_tracks += len(ti["depths"])
    assert n_tracks > 0


@pytest.mark.parametrize("images_2", [False, True])
def test_factor_two_matches_jax(tmp_path, images_2):
    """images_2/ read as it is, or images/ downscaled by the port's box
    average: bit for bit the JAX package's cv2.INTER_AREA."""
    root = write_colmap_dir(str(tmp_path), np.random.default_rng(3),
                            width=48, height=36,
                            models=("PINHOLE", "SIMPLE_PINHOLE"),
                            images_2=images_2)
    jp, tp = parsers(root, factor=2)
    assert tp.image_dir == jp.image_dir
    assert tp.image_dir.endswith("images_2") == images_2
    jd, td = jcolmap.Dataset(jp), tcolmap.Dataset(tp)
    for i in range(len(jd)):
        _items_equal(td[i], jd[i])
        assert td[i]["image"].shape == (18, 24, 3)


@pytest.mark.parametrize("k", [2, 3, 4])
def test_area_downscale_is_cv2_inter_area(rng, k):
    import cv2

    img = rng.integers(0, 256, (12 * k, 20 * k, 3), dtype=np.uint8)
    ref = cv2.resize(img, (20, 12), interpolation=cv2.INTER_AREA)
    np.testing.assert_array_equal(tcolmap.area_downscale(img, k), ref)


def test_undistortion_without_cv2_raises(colmap_dir, monkeypatch):
    """Undistortion and non-integer resizes need cv2: without it the
    loader raises, naming the camera model or the sizes, and never skips
    them."""
    real_import = builtins.__import__

    def no_cv2(name, *a, **kw):
        if name == "cv2":
            raise ImportError("no cv2")
        return real_import(name, *a, **kw)

    tp = tcolmap.Parser(colmap_dir)
    td = tcolmap.Dataset(tp, split="train")
    monkeypatch.setattr(builtins, "__import__", no_cv2)
    models = {tp.model_dict[tp.camera_ids[int(i)]]: j
              for j, i in enumerate(td.indices)}
    td[models["PINHOLE"]]  # no distortion: no cv2 needed
    with pytest.raises(RuntimeError, match="OPENCV camera"):
        td[models["OPENCV"]]
    with pytest.raises(RuntimeError, match="32x24 to 20x15"):
        tcolmap._resize(np.zeros((24, 32, 3), np.uint8), (20, 15), "x.png")


def test_non_png_without_imageio_raises(tmp_path, monkeypatch):
    real_import = builtins.__import__

    def no_imageio(name, *a, **kw):
        if name.startswith("imageio"):
            raise ImportError("no imageio")
        return real_import(name, *a, **kw)

    path = tmp_path / "view.jpg"
    path.write_bytes(b"\xff\xd8")
    monkeypatch.setattr(builtins, "__import__", no_imageio)
    with pytest.raises(RuntimeError, match=r"view\.jpg: a \.jpg image"):
        tcolmap.read_image(str(path))


@pytest.mark.parametrize("split", ["train", "val"])
def test_gsc_dataset_splits_match_jax(colmap_dir, split):
    jp, tp = parsers(colmap_dir)
    jd = jcolmap.GSCDataset(jp, split=split, test_view_ids=(4, 1))
    td = tcolmap.GSCDataset(tp, split=split, test_view_ids=(4, 1))
    np.testing.assert_array_equal(td.indices, jd.indices)
    assert len(td) == (2 if split == "val" else 7)
    _items_equal(td[0], jd[0], image_atol=1 / 255)


@pytest.mark.parametrize("kind", ["interp", "ellipse", "spiral"])
def test_trajectories_match_jax(colmap_dir, kind):
    _, tp = parsers(colmap_dir)
    c2ws = tp.camtoworlds
    fn = {"interp": "generate_interpolated_path",
          "ellipse": "generate_ellipse_path",
          "spiral": "generate_spiral_path"}[kind]
    arg = 3 if kind == "interp" else 10
    ref = getattr(jtraj, fn)(c2ws, arg)
    got = getattr(ttraj, fn)(c2ws, arg)
    assert got.shape == ref.shape and got.shape[1:] == (4, 4)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
