"""PLY save/load with the Inria 3DGS attribute naming
(f_dc_*/f_rest_*/scale_*/rot_*), for interchange with the 3DGS ecosystem
(port of gscodec_studio_tpu/utils/ply.py; a self-contained binary PLY
reader and writer on numpy)."""

from __future__ import annotations

from typing import Dict

import numpy as np


def save_ply(path: str, splats: Dict[str, np.ndarray]) -> None:
    splats = {k: np.asarray(v, np.float32) for k, v in splats.items()}
    n = len(splats["means"])
    sh0 = splats["sh0"].reshape(n, -1)  # [n, 3]
    # Inria layout stores f_rest channel-major: [3, K-1] flattened.
    shN_cm = splats["shN"].transpose(0, 2, 1).reshape(n, -1)

    cols = [
        ("x", splats["means"][:, 0]),
        ("y", splats["means"][:, 1]),
        ("z", splats["means"][:, 2]),
        ("nx", np.zeros(n, np.float32)),
        ("ny", np.zeros(n, np.float32)),
        ("nz", np.zeros(n, np.float32)),
    ]
    cols += [(f"f_dc_{i}", sh0[:, i]) for i in range(sh0.shape[1])]
    cols += [(f"f_rest_{i}", shN_cm[:, i]) for i in range(shN_cm.shape[1])]
    cols += [("opacity", splats["opacities"])]
    cols += [(f"scale_{i}", splats["scales"][:, i]) for i in range(3)]
    cols += [(f"rot_{i}", splats["quats"][:, i]) for i in range(4)]

    with open(path, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0",
                  f"element vertex {n}"]
        header += [f"property float {name}" for name, _ in cols]
        header += ["end_header"]
        f.write(("\n".join(header) + "\n").encode("ascii"))
        data = np.stack([c for _, c in cols], axis=1).astype("<f4")
        f.write(data.tobytes())


def load_ply(path: str) -> Dict[str, np.ndarray]:
    with open(path, "rb") as f:
        props = []
        n = 0
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property"):
                props.append(line.split()[-1])
            elif line == "end_header":
                break
        data = np.frombuffer(f.read(n * len(props) * 4), "<f4").reshape(
            n, len(props)
        )
    col = {p: data[:, i] for i, p in enumerate(props)}
    means = np.stack([col["x"], col["y"], col["z"]], 1)
    sh0 = np.stack([col[f"f_dc_{i}"] for i in range(3)], 1)[:, None, :]
    rest = sorted(
        (p for p in props if p.startswith("f_rest_")),
        key=lambda p: int(p.split("_")[-1]),
    )
    if rest:
        k1 = len(rest) // 3
        shN = np.stack([col[p] for p in rest], 1).reshape(n, 3, k1)
        shN = shN.transpose(0, 2, 1)
    else:
        shN = np.zeros((n, 0, 3), np.float32)
    return {
        "means": means.astype(np.float32),
        "sh0": np.ascontiguousarray(sh0, np.float32),
        "shN": np.ascontiguousarray(shN, np.float32),
        "opacities": col["opacity"].astype(np.float32),
        "scales": np.stack([col[f"scale_{i}"] for i in range(3)], 1).astype(
            np.float32
        ),
        "quats": np.stack([col[f"rot_{i}"] for i in range(4)], 1).astype(
            np.float32
        ),
    }
