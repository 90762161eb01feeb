"""Graph distribution statistics: degree / clustering / orbit MMD between
reference and generated graph sets; the port's copy of
reed_tpu/eval/graph_stats.py (host-side numpy).

The counterpart of molecule/eval_src/evaluation/{stats.py,mmd.py}:
histogram-based MMD with gaussian(-TV/-EMD) kernels, degree and clustering
histograms, and 4-node orbit statistics via the port's ORCA counter
(eval/orca). Graphs are (n, edges[m,2]) pairs — no networkx
dependency required.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

Graph = Tuple[int, np.ndarray]  # (num_nodes, edges [m, 2])


def degree_histogram(g: Graph, max_deg: int) -> np.ndarray:
    n, edges = g
    deg = np.zeros(n, np.int64)
    for u, v in np.asarray(edges).reshape(-1, 2):
        if u != v:
            deg[u] += 1
            deg[v] += 1
    hist = np.bincount(deg, minlength=max_deg + 1).astype(np.float64)
    return hist / max(1, hist.sum())


def clustering_coefficients(g: Graph) -> np.ndarray:
    n, edges = g
    adj = np.zeros((n, n), bool)
    for u, v in np.asarray(edges).reshape(-1, 2):
        if u != v:
            adj[u, v] = adj[v, u] = True
    coeffs = np.zeros(n)
    for v in range(n):
        nbrs = np.flatnonzero(adj[v])
        k = len(nbrs)
        if k < 2:
            continue
        sub = adj[np.ix_(nbrs, nbrs)]
        coeffs[v] = sub.sum() / (k * (k - 1))
    return coeffs


def clustering_histogram(g: Graph, bins: int = 100) -> np.ndarray:
    hist, _ = np.histogram(clustering_coefficients(g), bins=bins,
                           range=(0.0, 1.0), density=False)
    hist = hist.astype(np.float64)
    return hist / max(1, hist.sum())


def _adjacency(g: Graph) -> np.ndarray:
    n, edges = g
    adj = np.zeros((n, n), bool)
    for u, v in np.asarray(edges).reshape(-1, 2):
        if u != v:
            adj[u, v] = adj[v, u] = True
    return adj


def spectral_histogram(g: Graph, bins: int = 200) -> np.ndarray:
    """Normalized-Laplacian eigenvalue histogram over [0, 2]
    (reference: stats.py:78-90 spectral_worker)."""
    n, _ = g
    adj = _adjacency(g).astype(np.float64)
    deg = adj.sum(1)
    with np.errstate(divide="ignore"):
        d_isqrt = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-12)),
                           0.0)
    lap = np.eye(n) * (deg > 0) - d_isqrt[:, None] * adj * d_isqrt[None, :]
    try:
        eigs = np.linalg.eigvalsh(lap)
    except np.linalg.LinAlgError:
        eigs = np.zeros(n)
    hist, _ = np.histogram(eigs, bins=bins, range=(-1e-5, 2.0),
                           density=False)
    hist = hist.astype(np.float64)
    return hist / max(1, hist.sum())


def spectral_stats(ref: Sequence[Graph], pred: Sequence[Graph]) -> float:
    """Spectral MMD (reference: stats.py:92-131 spectral_stats)."""
    hx = [spectral_histogram(g) for g in ref if g[0] > 0]
    hy = [spectral_histogram(g) for g in pred if g[0] > 0]
    return mmd(hx, hy, kernel=gaussian_tv_kernel, sigma=1.0)


def connected_fraction(pred: Sequence[Graph]) -> float:
    """Fraction of generated graphs whose non-isolated nodes form one
    connected component (reference: stats.py:506-518 connected_stats)."""
    if not pred:
        return float("nan")
    count = 0
    for g in pred:
        adj = _adjacency(g)
        keep = np.flatnonzero(adj.any(axis=1))
        if len(keep) == 0:
            continue
        sub = adj[np.ix_(keep, keep)]
        seen = np.zeros(len(keep), bool)
        stack = [0]
        seen[0] = True
        while stack:
            v = stack.pop()
            for u in np.flatnonzero(sub[v]):
                if not seen[u]:
                    seen[u] = True
                    stack.append(int(u))
        if seen.all():
            count += 1
    return count / float(len(pred))


# -- NSPDK (reference: mmd.py:160-171 via the vendored EDEN vectorizer) ------

def _wl_neighborhood_hashes(adj: np.ndarray, labels: Sequence[int],
                            radius: int) -> List[np.ndarray]:
    """Per-node canonical hashes of the r-ball neighborhood subgraph for
    r = 0..radius, via Weisfeiler-Lehman iterative relabeling (a clean-room
    stand-in for EDEN's exact neighborhood-subgraph canonicalization)."""
    def mix(*vals: int) -> int:
        acc = 0x811C9DC5
        for v in vals:
            acc = ((acc ^ (v & 0xFFFFFFFF)) * 0x01000193) & 0xFFFFFFFF
        return acc & 0x7FFFFFFF

    n = adj.shape[0]
    h = np.array([mix(1, int(l)) for l in labels], np.int64)
    out = [h.copy()]
    for _ in range(radius):
        nxt = np.empty_like(h)
        for v in range(n):
            nbr = sorted(int(h[u]) for u in np.flatnonzero(adj[v]))
            nxt[v] = mix(int(h[v]), *nbr)
        h = nxt
        out.append(h.copy())
    return out


def nspdk_features(g: Graph, labels: Optional[Sequence[int]] = None,
                   radius: int = 2, distance: int = 4) -> dict:
    """Sparse NSPDK feature map: counts of (hash_r(u), hash_r(v), d) pairs
    of neighborhood-subgraph hashes at shortest-path distance d <= D,
    L2-normalized per graph (EDEN vectorize(complexity=4) equivalent)."""
    n, _ = g
    if n == 0:
        return {}
    adj = _adjacency(g)
    labels = list(labels) if labels is not None else [0] * n
    hashes = _wl_neighborhood_hashes(adj, labels, radius)
    # BFS all-pairs shortest paths (unweighted, small molecular graphs)
    dist = np.full((n, n), -1, np.int64)
    for s in range(n):
        dist[s, s] = 0
        frontier = [s]
        d = 0
        while frontier and d < distance:
            d += 1
            nxt = []
            for v in frontier:
                for u in np.flatnonzero(adj[v]):
                    if dist[s, u] < 0:
                        dist[s, u] = d
                        nxt.append(int(u))
            frontier = nxt
    feats: dict = {}
    for r in range(radius + 1):
        hr = hashes[r]
        for u in range(n):
            for v in range(u, n):
                d = dist[u, v]
                if d < 0 or d > distance:
                    continue
                a, b = sorted((int(hr[u]), int(hr[v])))
                key = (r, d, a, b)
                feats[key] = feats.get(key, 0.0) + 1.0
    norm = np.sqrt(sum(c * c for c in feats.values()))
    if norm > 0:
        feats = {k: c / norm for k, c in feats.items()}
    return feats


def _sparse_linear_kernel_mean(xs: List[dict], ys: List[dict]) -> float:
    total = 0.0
    for fx in xs:
        for fy in ys:
            small, big = (fx, fy) if len(fx) <= len(fy) else (fy, fx)
            total += sum(c * big.get(k, 0.0) for k, c in small.items())
    return total / max(1, len(xs) * len(ys))


def nspdk_stats(ref: Sequence[Graph], pred: Sequence[Graph],
                ref_labels: Optional[Sequence[Sequence[int]]] = None,
                pred_labels: Optional[Sequence[Sequence[int]]] = None
                ) -> float:
    """NSPDK MMD with a linear kernel over normalized sparse features
    (reference: mmd.py:160-171 compute_nspdk_mmd)."""
    ref = [g for g in ref if g[0] > 0]
    pred = [g for g in pred if g[0] > 0]
    if not ref or not pred:
        return float("nan")
    fx = [nspdk_features(g, (ref_labels[i] if ref_labels else None))
          for i, g in enumerate(ref)]
    fy = [nspdk_features(g, (pred_labels[i] if pred_labels else None))
          for i, g in enumerate(pred)]
    return (_sparse_linear_kernel_mean(fx, fx)
            + _sparse_linear_kernel_mean(fy, fy)
            - 2 * _sparse_linear_kernel_mean(fx, fy))


def orbit_counts_per_graph(g: Graph) -> np.ndarray:
    """Mean node-orbit counts (15 dims) (reference: stats.py:231-257)."""
    from reed_tpu_torch.eval.orca import count_node_orbits4

    n, edges = g
    counts = count_node_orbits4(n, np.asarray(edges).reshape(-1, 2))
    return counts.sum(axis=0) / max(1, n)


# -- MMD (reference: evaluation/mmd.py) ------------------------------------

def gaussian_tv_kernel(x: np.ndarray, y: np.ndarray,
                       sigma: float = 1.0) -> float:
    """exp(-TV(x,y)^2 / (2 sigma^2)) over histograms padded to equal len."""
    support = max(len(x), len(y))
    x = np.pad(x, (0, support - len(x)))
    y = np.pad(y, (0, support - len(y)))
    dist = np.abs(x - y).sum() / 2.0
    return float(np.exp(-dist * dist / (2 * sigma * sigma)))


def gaussian_kernel(x: np.ndarray, y: np.ndarray,
                    sigma: float = 1.0) -> float:
    support = max(len(x), len(y))
    x = np.pad(x, (0, support - len(x)))
    y = np.pad(y, (0, support - len(y)))
    dist = np.linalg.norm(x - y)
    return float(np.exp(-dist * dist / (2 * sigma * sigma)))


def mmd(samples_x: List[np.ndarray], samples_y: List[np.ndarray],
        kernel=gaussian_tv_kernel, **kw) -> float:
    """Squared population MMD between two sets of descriptors."""
    def avg_kernel(a, b):
        total = sum(kernel(x, y, **kw) for x in a for y in b)
        return total / (len(a) * len(b))

    if not samples_x or not samples_y:
        return float("nan")
    return (avg_kernel(samples_x, samples_x)
            + avg_kernel(samples_y, samples_y)
            - 2 * avg_kernel(samples_x, samples_y))


def degree_stats(ref: Sequence[Graph], pred: Sequence[Graph]) -> float:
    max_deg = 0
    for n, edges in list(ref) + list(pred):
        deg = np.zeros(n, np.int64)
        for u, v in np.asarray(edges).reshape(-1, 2):
            deg[u] += 1
            deg[v] += 1
        if n:
            max_deg = max(max_deg, int(deg.max()))
    hx = [degree_histogram(g, max_deg) for g in ref]
    hy = [degree_histogram(g, max_deg) for g in pred]
    return mmd(hx, hy, kernel=gaussian_tv_kernel, sigma=1.0)


def clustering_stats(ref: Sequence[Graph], pred: Sequence[Graph],
                     bins: int = 100) -> float:
    hx = [clustering_histogram(g, bins) for g in ref]
    hy = [clustering_histogram(g, bins) for g in pred]
    return mmd(hx, hy, kernel=gaussian_tv_kernel, sigma=0.1)


def orbit_stats(ref: Sequence[Graph], pred: Sequence[Graph]) -> float:
    """Orbit-count MMD (reference: stats.py orbit_stats_all)."""
    cx = [orbit_counts_per_graph(g) for g in ref if g[0] > 0]
    cy = [orbit_counts_per_graph(g) for g in pred if g[0] > 0]
    return mmd(cx, cy, kernel=gaussian_tv_kernel, sigma=30.0)


def all_graph_stats(ref: Sequence[Graph], pred: Sequence[Graph]) -> dict:
    return {
        "degree_mmd": degree_stats(ref, pred),
        "clustering_mmd": clustering_stats(ref, pred),
        "orbit_mmd": orbit_stats(ref, pred),
        "spectral_mmd": spectral_stats(ref, pred),
        "nspdk_mmd": nspdk_stats(ref, pred),
        "connected_frac": connected_fraction(pred),
    }
