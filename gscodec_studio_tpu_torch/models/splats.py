"""Static 3DGS splat parameters (port of
gscodec_studio_tpu/models/splats.py).

For training, the splats are a dict of tensors at a static capacity
``cap``: dead slots carry the opacity logit DEAD_OPACITY_LOGIT, render as
nothing (the renderer culls opacities below 1/255) and are recycled by the
densification strategy, as in the JAX package. ``SplatModel`` holds a
trained scene for rendering.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from gscodec_studio_tpu_torch.device import DeviceLike, resolve_device

PARAM_NAMES = ("means", "quats", "scales", "opacities", "sh0", "shN")
C0 = 0.28209479177387814  # SH DC basis
DEAD_OPACITY_LOGIT = -15.0  # sigmoid(-15) ~ 3e-7: culled by the renderer

# Per-parameter learning rates; the trainer multiplies means' by the scene
# scale.
PARAM_LRS = {
    "means": 1.6e-4,
    "scales": 5e-3,
    "quats": 1e-3,
    "opacities": 5e-2,
    "sh0": 2.5e-3,
    "shN": 2.5e-3 / 20,
    "features": 2.5e-3,
    "colors": 2.5e-3,
}


def rgb_to_sh(rgb):
    return (rgb - 0.5) / C0


def sh_to_rgb(sh):
    return sh * C0 + 0.5


def knn_mean_dist(points: np.ndarray, k: int = 4) -> np.ndarray:
    """sqrt(mean squared distance to the k-1 nearest neighbours), on the
    host (initialisation only)."""
    from scipy.spatial import cKDTree

    d, _ = cKDTree(points).query(points, k=k)
    return np.sqrt((d[:, 1:] ** 2).mean(axis=-1))


def create_splats(
    points: np.ndarray,  # [N, 3]
    rgbs: Optional[np.ndarray] = None,  # [N, 3] in [0, 1]
    cap: Optional[int] = None,
    sh_degree: int = 3,
    init_opacity: float = 0.1,
    init_scale: float = 1.0,
    feature_dim: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
) -> Dict[str, torch.Tensor]:
    """Splat parameters from a point cloud: ``cap`` >= N slots (default N),
    the slots past N dead. Scales are the log of the k-NN distance times
    ``init_scale``, opacities the logit of ``init_opacity``, sh0 from the
    colours and shN zero; quaternions (every slot) and, when ``rgbs`` is
    None, the colours are uniform draws from ``generator``. With
    ``feature_dim`` (the appearance path) the colour groups are instead
    ``features`` [cap, feature_dim], uniform draws, and ``colors`` [cap, 3],
    the logit of the colours clipped to [1e-4, 1 - 1e-4] (zero past N)."""
    dev = resolve_device(device)
    N = points.shape[0]
    cap = N if cap is None else cap
    if cap < N:
        raise ValueError(f"capacity {cap} below {N} points")
    rgb_in = None if rgbs is None or isinstance(rgbs, torch.Tensor) \
        else np.asarray(rgbs)
    if rgbs is None:
        rgbs = torch.rand((N, 3), generator=generator, device=dev)
    rgbs = torch.as_tensor(rgbs, dtype=torch.float32, device=dev)
    dist = np.maximum(knn_mean_dist(np.asarray(points), 4), 1e-7)
    scales = np.log(dist * init_scale)[:, None].repeat(3, axis=1)

    def padded(x, fill=0.0):
        out = torch.full((cap,) + tuple(x.shape[1:]), fill,
                         dtype=torch.float32, device=dev)
        out[:N] = torch.as_tensor(np.asarray(x, np.float32), device=dev)
        return out

    logit = math.log(init_opacity / (1 - init_opacity))
    splats = {
        "means": padded(points),
        "scales": padded(scales, fill=-10.0),
        "quats": torch.rand((cap, 4), generator=generator, device=dev),
        "opacities": padded(np.full(N, logit, np.float32),
                            fill=DEAD_OPACITY_LOGIT),
    }
    if feature_dim is None:
        K = (sh_degree + 1) ** 2
        sh0 = torch.zeros((cap, 1, 3), dtype=torch.float32, device=dev)
        sh0[:N, 0] = rgb_to_sh(rgbs)
        splats["sh0"] = sh0
        splats["shN"] = torch.zeros((cap, K - 1, 3), dtype=torch.float32,
                                    device=dev)
    else:
        splats["features"] = torch.rand((cap, feature_dim),
                                        generator=generator, device=dev)
        # the logit in the colours' own precision, as the JAX package
        # takes it (float64 for an SfM cloud's 0..255 / 255.0)
        c = np.clip(rgb_in if rgb_in is not None
                    else rgbs.cpu().numpy(), 1e-4, 1 - 1e-4)
        splats["colors"] = padded(np.log(c / (1 - c)))
    return splats


def num_live(splats: Dict[str, torch.Tensor], eps: float = 0.005) -> int:
    """Slots whose opacity exceeds the liveness threshold."""
    return int((torch.sigmoid(splats["opacities"]) > eps).sum())

# Log-scale floor inside the activation (the JAX package's LOG_SCALE_FLOOR):
# exp(-15) is sub-pixel at any working distance, and flooring keeps
# degenerate needles out of the projection.
LOG_SCALE_FLOOR = -15.0


class SplatModel(nn.Module):
    """The six parameter tensors of a splat scene, as the JAX package saves
    them: means [N,3], quats [N,4], scales [N,3] (log), opacities [N]
    (logit), sh0 [N,1,3], shN [N,K-1,3]."""

    def __init__(self, params: Dict[str, torch.Tensor]):
        super().__init__()
        missing = [k for k in PARAM_NAMES if k not in params]
        if missing:
            raise ValueError(f"splat parameters missing: {missing}")
        for name in PARAM_NAMES:
            setattr(self, name, nn.Parameter(params[name]))

    @property
    def num_splats(self) -> int:
        return self.means.shape[0]

    @property
    def sh_degree(self) -> int:
        k_total = 1 + self.shN.shape[1]
        return max(int(round(np.sqrt(k_total))) - 1, 0)

    def sh_coeffs(self) -> torch.Tensor:
        """[N, K, 3]: sh0 followed by shN."""
        return torch.cat([self.sh0, self.shN], dim=1)


def from_jax_splats(d: Dict[str, np.ndarray],
                    device: DeviceLike = None) -> SplatModel:
    """A SplatModel from the JAX package's splat dict (log scales, logit
    opacities), on ``device`` (None means the CUDA card)."""
    dev = resolve_device(device)
    n = len(d["means"])
    sh0 = np.asarray(d.get("sh0", np.zeros((n, 1, 3)))).reshape(n, 1, 3)
    shN = np.asarray(d.get("shN", np.zeros((n, 0, 3)))).reshape(n, -1, 3)
    arrays = dict(means=d["means"], quats=d["quats"], scales=d["scales"],
                  opacities=np.asarray(d["opacities"]).reshape(n),
                  sh0=sh0, shN=shN)
    return SplatModel({
        k: torch.as_tensor(np.asarray(v), dtype=torch.float32, device=dev)
        for k, v in arrays.items()
    })


def flatten_tree(tree, prefix: str = "") -> Dict:
    """A nested tree of dicts and lists -> {dotted name: leaf}; a list's
    entries are named by their index ("entropy.quats.mlp.0.w")."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}{k}."))
    return out


def unflatten_tree(flat: Dict, prefix: str = ""):
    """flatten_tree's inverse over the names that start with ``prefix``:
    a level whose names are all digits becomes a list."""
    root: Dict = {}
    for k, v in flat.items():
        if not k.startswith(prefix):
            continue
        parts = k[len(prefix):].split(".")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def jax_leaf_order(names) -> list:
    """Flat names in the order in which jax.tree_util flattens the tree
    they come from: a dict's keys sorted, a list's entries by index. The
    checkpoints' ``sim/<i>`` leaves are numbered in this order: the mask,
    then each attribute's model (a factorized one's biases, factors and
    matrices; a hash-grid one's grid3d, mlp.0.b, mlp.0.w, mlp.1.b,
    mlp.1.w and planes.0-2)."""
    return sorted(names, key=lambda k: tuple(
        (0, int(p), "") if p.isdigit() else (1, 0, p) for p in k.split(".")))


def from_jax_sim_params(tree: Dict, device: DeviceLike = None
                        ) -> Dict[str, torch.Tensor]:
    """The port's flat sim_params (compression_sim/simulation.py) from the
    JAX package's sim_params pytree as numpy arrays: {"entropy": {attr:
    model}, "ada_mask": [cap]}, a model being factorized ({"matrices",
    "biases", "factors"}: lists) or a hash-grid one ({"grid3d", "planes":
    [3], "mlp": [{"w", "b"} x 2]}). Also takes the pytrees of its optax
    Adam moments (mu, nu), which have the same structure, and the JAX
    Runner's other parameter trees: its aux_params ({"pose": [n, 9],
    "app_embeds": [n, e], "app_mlp": [{"w", "b"} x 2], "bilagrid":
    [n, D, H, W, 12]}, any of them absent) become the Runner's flat
    aux_params (pose, app_embeds, app_mlp.<i>.w/b, bilagrid), and its
    splats dict (with "features" and "colors" under app_opt) the
    Runner's splats."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.array(a), dtype=torch.float32, device=dev)
            for k, a in flatten_tree(tree).items()}


def codec_models_from_jax(models: Optional[Dict],
                          device: DeviceLike = None) -> Optional[Dict]:
    """The rANS codec's entropy models (compression/entropy_coding.py)
    from the JAX package's, as numpy or JAX arrays: {attr: factorized
    model} -> {attr: the same tree of float32 tensors}, and {attr:
    ("gaussian", (hash-grid params, (cfg3d, cfg2d, channel)))} -> the
    same with the port's HashGridCfg."""
    if models is None:
        return None
    from gscodec_studio_tpu_torch.compression_sim.hash_grid import (
        HashGridCfg)

    dev = resolve_device(device)
    out = {}
    for name, m in models.items():
        if isinstance(m, tuple) and m[0] == "gaussian":
            params, (cfg3d, cfg2d, channel) = m[1]
            out[name] = ("gaussian", (
                unflatten_tree(from_jax_sim_params(params, dev)),
                (HashGridCfg(*cfg3d), HashGridCfg(*cfg2d), int(channel))))
        else:
            out[name] = unflatten_tree(from_jax_sim_params(m, dev))
    return out


def from_jax_adam_state(count, mu: Dict, nu: Dict,
                        device: DeviceLike = None) -> Dict[str, dict]:
    """The port's Adam states of the sim parameters ({name: {"count",
    "exp_avg", "exp_avg_sq"}}) from an optax ScaleByAdamState's count and
    moment pytrees, as numpy arrays."""
    mu_t = from_jax_sim_params(mu, device)
    nu_t = from_jax_sim_params(nu, device)
    return {k: {"count": int(np.array(count)), "exp_avg": mu_t[k],
                "exp_avg_sq": nu_t[k]} for k in mu_t}


def from_jax_selective_adam_states(states: Dict, device: DeviceLike = None
                                   ) -> Dict[str, dict]:
    """The port's per-group optimizer states from the JAX package's
    {name: SelectiveAdamState(count, mu, nu)} (numpy or JAX arrays): the
    same layout as plain Adam's, {"count", "exp_avg", "exp_avg_sq"}."""
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.array(a), dtype=torch.float32, device=dev)

    return {name: {"count": int(np.array(st.count)), "exp_avg": t(st.mu),
                   "exp_avg_sq": t(st.nu)} for name, st in states.items()}


def from_jax_mcmc_state(state: Dict, device: DeviceLike = None
                        ) -> Dict[str, torch.Tensor]:
    """The port's MCMC strategy state from the JAX package's ("allocated"
    bool [cap], "scene_scale"), as numpy arrays."""
    dev = resolve_device(device)
    return {"allocated": torch.as_tensor(np.array(state["allocated"]),
                                         dtype=torch.bool, device=dev),
            "scene_scale": torch.as_tensor(np.array(state["scene_scale"]),
                                           dtype=torch.float32, device=dev)}


def from_jax_decoder(params: Dict, opt_state=None,
                     device: DeviceLike = None):
    """The Sandwich decoder of the JAX package's DynRunner ({"w1", "w2"},
    numpy or JAX arrays) as tensors, and with ``opt_state`` (its optax
    Adam state, whose first entry is the ScaleByAdamState) the port's
    per-name Adam states: (params, states or None)."""
    dev = resolve_device(device)
    out = {k: torch.as_tensor(np.array(v), dtype=torch.float32, device=dev)
           for k, v in params.items()}
    if opt_state is None:
        return out, None
    adam = opt_state[0]
    return out, from_jax_adam_state(adam.count, adam.mu, adam.nu, dev)


def from_jax_stg_state(state: Dict, device: DeviceLike = None
                       ) -> Dict[str, torch.Tensor]:
    """The port's STG strategy state from the JAX package's: the default
    strategy's float32 accumulators (grad2d, count, radii, scene_scale),
    densify_count (int32) and omega_keep (bool)."""
    dev = resolve_device(device)
    dtypes = {"densify_count": torch.int32, "omega_keep": torch.bool}
    return {k: torch.as_tensor(np.array(v), device=dev,
                               dtype=dtypes.get(k, torch.float32))
            for k, v in state.items()}


def splat_activations(
    splats,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(means, quats, exp(max(scales, floor)), sigmoid(opacities)) -- the
    linear-domain tensors the renderer consumes. ``splats`` is a SplatModel
    or a dict of tensors."""
    get = (lambda k: splats[k]) if isinstance(splats, dict) else \
        (lambda k: getattr(splats, k))
    return (
        get("means"),
        get("quats"),
        torch.exp(torch.clamp(get("scales"), min=LOG_SCALE_FLOOR)),
        torch.sigmoid(get("opacities")),
    )
