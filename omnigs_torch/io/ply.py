"""PLY I/O — the checkpoint format of the 3DGS ecosystem.

Counterpart of `omnigs_tpu/io/ply.py`, byte-compatible with it: a file
written by either package loads in the other.

* Gaussian checkpoints: binary little-endian `vertex` with properties
  x,y,z, nx,ny,nz (zeros), f_dc_0..2, f_rest_0..44 (features transposed to
  channel-major before flattening), opacity, scale_0..2, rot_0..3 — all raw
  (pre-activation) values. Only active slots are written.
* SfM sparse clouds: float (360Roam) or double (EgoNeRF) xyz with optional
  uchar rgb; written as float xyz, zero normals and uchar rgb.

Implemented on numpy structured arrays (no external ply dependency).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple, Union

import numpy as np

from omnigs_torch.model.gaussians import SH_REST, GaussianModel

_PLY_DTYPES = {
    "float": "<f4",
    "float32": "<f4",
    "double": "<f8",
    "float64": "<f8",
    "uchar": "u1",
    "uint8": "u1",
    "char": "i1",
    "int8": "i1",
    "short": "<i2",
    "ushort": "<u2",
    "int": "<i4",
    "int32": "<i4",
    "uint": "<u4",
    "uint32": "<u4",
}


def _read_ply_vertices(path: Union[str, Path]) -> Dict[str, np.ndarray]:
    data = Path(path).read_bytes()
    end = data.find(b"end_header\n")
    if end < 0:
        raise ValueError(f"{path}: not a PLY file")
    header = data[:end].decode("ascii", errors="replace").splitlines()
    body = data[end + len(b"end_header\n") :]

    fmt = None
    counts: List[Tuple[str, int]] = []
    props: Dict[str, List[Tuple[str, str]]] = {}
    cur = None
    for line in header:
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            cur = tok[1]
            counts.append((cur, int(tok[2])))
            props[cur] = []
        elif tok[0] == "property" and cur is not None:
            if tok[1] == "list":
                raise NotImplementedError("list properties unsupported")
            props[cur].append((tok[2], _PLY_DTYPES[tok[1]]))
    if fmt not in ("binary_little_endian", "ascii"):
        raise NotImplementedError(f"PLY format {fmt}")

    out: Dict[str, np.ndarray] = {}
    offset = 0
    for name, count in counts:
        dtype = np.dtype(props[name])
        if fmt == "binary_little_endian":
            arr = np.frombuffer(body, dtype=dtype, count=count, offset=offset)
            offset += dtype.itemsize * count
        else:
            text = body.decode("ascii").split()
            ncol = len(props[name])
            vals = np.array(text[: count * ncol], dtype=np.float64).reshape(
                count, ncol
            )
            arr = np.zeros(count, dtype=dtype)
            for i, (pname, _) in enumerate(props[name]):
                arr[pname] = vals[:, i]
        if name == "vertex":
            for pname, _ in props[name]:
                out[pname] = np.ascontiguousarray(arr[pname])
    return out


def _write_ply(path: Union[str, Path], columns: List[Tuple[str, str, np.ndarray]]):
    n = columns[0][2].shape[0]
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    for name, typ, _ in columns:
        header.append(f"property {typ} {name}")
    header.append("end_header")
    dtype = np.dtype([(name, _PLY_DTYPES[typ]) for name, typ, _ in columns])
    rec = np.zeros(n, dtype=dtype)
    for name, _, col in columns:
        rec[name] = col
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(rec.tobytes())


def save_gaussian_ply(path: Union[str, Path], model: GaussianModel) -> None:
    """Write the active slots of ``model`` in the reference PLY layout."""
    m = model.to_numpy()
    act = m["active"]
    xyz = m["xyz"][act].astype(np.float32)
    n = xyz.shape[0]
    # channel-major flatten: transpose(1,2) then flatten
    f_dc = np.transpose(m["features_dc"][act], (0, 2, 1)).reshape(n, -1)
    f_rest = np.transpose(m["features_rest"][act], (0, 2, 1)).reshape(n, -1)
    opacity = m["opacity"][act].reshape(n)
    scale = m["scaling"][act]
    rot = m["rotation"][act]

    cols: List[Tuple[str, str, np.ndarray]] = []
    for i, name in enumerate("xyz"):
        cols.append((name, "float", xyz[:, i]))
    for name in ("nx", "ny", "nz"):
        cols.append((name, "float", np.zeros(n, np.float32)))
    for i in range(f_dc.shape[1]):
        cols.append((f"f_dc_{i}", "float", f_dc[:, i].astype(np.float32)))
    for i in range(f_rest.shape[1]):
        cols.append((f"f_rest_{i}", "float", f_rest[:, i].astype(np.float32)))
    cols.append(("opacity", "float", opacity.astype(np.float32)))
    for i in range(scale.shape[1]):
        cols.append((f"scale_{i}", "float", scale[:, i].astype(np.float32)))
    for i in range(rot.shape[1]):
        cols.append((f"rot_{i}", "float", rot[:, i].astype(np.float32)))
    _write_ply(path, cols)


def load_gaussian_ply(
    path: Union[str, Path], capacity: int = 0, device="cuda"
) -> GaussianModel:
    """PLY → GaussianModel on ``device`` with capacity ≥ point count (extra
    slots inactive)."""
    v = _read_ply_vertices(path)
    n = v["x"].shape[0]
    cap = max(capacity, n)
    xyz = np.stack([v["x"], v["y"], v["z"]], axis=-1).astype(np.float32)
    f_dc = np.stack([v[f"f_dc_{i}"] for i in range(3)], axis=-1).reshape(n, 1, 3)
    rest_cols = [v[f"f_rest_{i}"] for i in range(SH_REST * 3)]
    # file is channel-major (3, 15) per point → back to (15, 3)
    f_rest = np.stack(rest_cols, axis=-1).reshape(n, 3, SH_REST)
    f_rest = np.transpose(f_rest, (0, 2, 1)).astype(np.float32)
    opacity = v["opacity"].reshape(n, 1).astype(np.float32)
    scale = np.stack([v[f"scale_{i}"] for i in range(3)], axis=-1).astype(np.float32)
    rot = np.stack([v[f"rot_{i}"] for i in range(4)], axis=-1).astype(np.float32)

    m = GaussianModel.empty(cap, device="cpu").to_numpy()
    for k, val in (
        ("xyz", xyz),
        ("features_dc", f_dc),
        ("features_rest", f_rest),
        ("opacity", opacity),
        ("scaling", scale),
        ("rotation", rot),
    ):
        m[k][:n] = val
    m["active"][:n] = True
    return GaussianModel.from_numpy(m, device=device)


def load_points_ply(path: Union[str, Path]) -> Tuple[np.ndarray, np.ndarray]:
    """SfM sparse cloud → ((N, 3) float32 points, (N, 3) float32 colors in
    [0, 1]); float or double xyz, mid-grey where the file has no rgb."""
    v = _read_ply_vertices(path)
    pts = np.stack([v["x"], v["y"], v["z"]], axis=-1).astype(np.float32)
    if "red" in v:
        cols = (
            np.stack([v["red"], v["green"], v["blue"]], axis=-1).astype(np.float32)
            / 255.0
        )
    else:
        cols = np.full_like(pts, 0.5)
    return pts, cols


def save_points_ply(
    path: Union[str, Path], points: np.ndarray, colors: np.ndarray
) -> None:
    """Write a sparse cloud: float xyz, zero normals, uchar rgb of the
    colors clipped to [0, 1] (``saveSparsePointsPly``)."""
    pts = np.asarray(points, np.float32)
    rgb = (np.clip(np.asarray(colors), 0, 1) * 255).astype(np.uint8)
    cols: List[Tuple[str, str, np.ndarray]] = []
    for i, name in enumerate("xyz"):
        cols.append((name, "float", pts[:, i]))
    for name in ("nx", "ny", "nz"):
        cols.append((name, "float", np.zeros(pts.shape[0], np.float32)))
    for i, name in enumerate(("red", "green", "blue")):
        cols.append((name, "uchar", rgb[:, i]))
    _write_ply(path, cols)
