"""Port of esm_tpu/apps/ppl/geometry.py, copied: numpy on the host (the
JAX package has no device SASA either).

Host-side structural geometry for energy terms (numpy).

The reference delegates to biotite (sasa, annotate_sse, superimpose, rmsd).
These are standalone numpy implementations:
  * Shrake-Rupley solvent-accessible surface area (per-atom boolean surface),
  * Kabsch superposition + RMSD,
  * a P-SEA-style secondary structure annotation from CA geometry.
"""

from __future__ import annotations

import numpy as np

# van der Waals radii (Å) by element, as used for SASA
VDW_RADII = {"C": 1.7, "N": 1.55, "O": 1.52, "S": 1.8, "H": 1.2}
PROBE_RADIUS = 1.4


def _fibonacci_sphere(n: int) -> np.ndarray:
    i = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5 ** 0.5) * i
    return np.stack(
        [np.cos(theta) * np.sin(phi), np.sin(theta) * np.sin(phi), np.cos(phi)], -1
    )


def sasa(
    coords: np.ndarray, elements: np.ndarray, n_points: int = 100
) -> np.ndarray:
    """Shrake-Rupley SASA. coords (N,3), elements (N,) single-letter strings.
    Returns per-atom accessible area (Å²); >0 means surface-exposed (matching
    biotite.structure.sasa's use as a boolean in the reference energies)."""
    n = coords.shape[0]
    radii = np.array([VDW_RADII.get(e, 1.7) for e in elements]) + PROBE_RADIUS
    sphere = _fibonacci_sphere(n_points)
    out = np.zeros(n)
    # neighbor search with a generous cutoff
    max_r = radii.max()
    d2 = np.sum((coords[:, None] - coords[None]) ** 2, -1)
    for i in range(n):
        nbr = np.where(
            (d2[i] < (radii[i] + max_r) ** 2) & (np.arange(n) != i)
        )[0]
        pts = coords[i] + radii[i] * sphere
        if len(nbr):
            pd2 = np.sum((pts[:, None] - coords[nbr][None]) ** 2, -1)
            buried = np.any(pd2 < (radii[nbr] ** 2)[None], axis=-1)
        else:
            buried = np.zeros(n_points, bool)
        frac = 1.0 - buried.mean()
        out[i] = 4 * np.pi * radii[i] ** 2 * frac
    return out


def kabsch_superimpose(fixed: np.ndarray, mobile: np.ndarray) -> np.ndarray:
    """Superimpose mobile (N,3) onto fixed (N,3); returns transformed mobile."""
    cf = fixed.mean(0)
    cm = mobile.mean(0)
    h = (mobile - cm).T @ (fixed - cf)
    u, _, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    r = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
    return (mobile - cm) @ r.T + cf


def rmsd(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.sqrt(np.mean(np.sum((a - b) ** 2, axis=-1))))


def annotate_sse_ca(ca: np.ndarray) -> np.ndarray:
    """P-SEA-style SSE annotation from CA coordinates.

    Returns array of 'a' (helix), 'b' (strand), 'c' (coil) per residue —
    the same label convention as biotite.structure.annotate_sse. Uses the
    P-SEA distance criteria: d(i,i+3)/d(i,i+4) for helices, d(i,i+2) ~6.7Å
    zig-zag for strands.
    """
    n = ca.shape[0]
    sse = np.full(n, "c", dtype="<U1")

    def d(i, j):
        return np.linalg.norm(ca[i] - ca[j])

    for i in range(n):
        if i + 4 < n:
            d13 = d(i, i + 3)
            d14 = d(i, i + 4)
            d12 = d(i, i + 2)
            if (5.0 <= d13 <= 6.4) and (5.0 <= d14 <= 6.6) and (5.1 <= d12 <= 6.1):
                sse[i : i + 5] = np.where(sse[i : i + 5] == "c", "a", sse[i : i + 5])
        if i + 2 < n:
            d12 = d(i, i + 2)
            if 6.4 <= d12 <= 7.4 and sse[i] == "c":
                d13v = d(i, i + 3) if i + 3 < n else None
                if d13v is None or d13v >= 9.0:
                    sse[i : i + 3] = np.where(
                        sse[i : i + 3] == "c", "b", sse[i : i + 3]
                    )
    return sse
