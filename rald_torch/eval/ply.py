"""Binary PLY point-cloud files in plain Python: the port's own copy of
``rald_tpu/eval/ply.py`` (the reference wrote them with open3d)."""
from __future__ import annotations

import os
import struct
from pathlib import Path

import numpy as np


def write_ply(path, points: np.ndarray, colors: np.ndarray | None = None) -> None:
    """Write (N, 3) float points (optionally (N, 3) uint8 colors) as binary
    PLY. The file is written aside and renamed: ranks that write the same
    frame (a sampler's padding) never leave a torn file."""
    points = np.ascontiguousarray(np.asarray(points, np.float32).reshape(-1, 3))
    n = len(points)
    header = [
        "ply",
        "format binary_little_endian 1.0",
        f"element vertex {n}",
        "property float x",
        "property float y",
        "property float z",
    ]
    if colors is not None:
        colors = np.ascontiguousarray(np.asarray(colors, np.uint8).reshape(-1, 3))
        if len(colors) != n:
            raise ValueError(f"write_ply: {len(colors)} colors for {n} points")
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header.append("end_header")

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    with open(tmp, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if colors is None:
            f.write(points.tobytes())
        else:
            for p, c in zip(points, colors):
                f.write(struct.pack("<fffBBB", p[0], p[1], p[2], c[0], c[1], c[2]))
    os.replace(tmp, path)


def read_ply(path) -> np.ndarray:
    """Reader for files written by :func:`write_ply`: (N, 3) float32."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        n = next(int(h.split()[-1]) for h in header if h.startswith("element vertex"))
        if not any("uchar" in h for h in header):
            return np.frombuffer(f.read(n * 12), dtype=np.float32).reshape(n, 3)
        pts = np.empty((n, 3), np.float32)
        for i in range(n):
            x, y, z, *_ = struct.unpack("<fffBBB", f.read(15))
            pts[i] = (x, y, z)
        return pts
