"""Synthetic clustered image data with feature skew (offline stand-in for
CIFAR-10 / Imagenette / Flickr-Mammals).

A copy of ``repro.data.synthetic``: numpy only, and byte-identical to it for
the same spec (the tests hold the two against each other).

Class structure: each class has a smooth random 'blob' prototype; samples are
prototype + small spatial jitter + Gaussian noise. Feature heterogeneity is
created exactly as in the paper: per-cluster image transforms — rotations
(Sec. V-A) or color filters (Appendix H). Labels stay uniform per node
(paper: 'uniform partitioning ... heterogeneity must be reflected in the
feature composition').
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class SynthSpec:
    n_classes: int = 10
    image_size: int = 16
    channels: int = 3
    samples_per_class: int = 32   # per node
    test_per_class: int = 32      # per cluster test set
    noise: float = 0.35
    jitter: int = 2               # max +/- pixel shift
    seed: int = 0


# --------------------------------------------------------------------------
# transforms (the paper's feature-skew generators)
def rotate(x, quarter_turns: int):
    return np.rot90(x, k=quarter_turns, axes=(-3, -2))


_SEPIA = np.array([[0.393, 0.769, 0.189],
                   [0.349, 0.686, 0.168],
                   [0.272, 0.534, 0.131]]).T


def apply_transform(x: np.ndarray, name: str) -> np.ndarray:
    """x [..., H, W, C] in [-1, 1]."""
    if name == "rot0" or name == "none":
        return x
    if name.startswith("rot"):
        deg = int(name[3:])
        return rotate(x, deg // 90)
    if name == "gray":
        g = x.mean(axis=-1, keepdims=True)
        return np.repeat(g, x.shape[-1], axis=-1)
    if name == "sepia":
        return np.clip((x * 0.5 + 0.5) @ _SEPIA, 0, 1) * 2.0 - 1.0
    if name == "saturate":
        g = x.mean(axis=-1, keepdims=True)
        return np.clip(g + 1.8 * (x - g), -1, 1)
    raise ValueError(f"unknown transform {name!r}")


# --------------------------------------------------------------------------
def _prototypes(rng, spec: SynthSpec):
    """Smooth per-class patterns: random coarse grids, bilinear-upsampled."""
    coarse = spec.image_size // 4
    protos = rng.normal(size=(spec.n_classes, coarse, coarse, spec.channels))
    # bilinear upsample x4 via repeat + box blur
    up = np.repeat(np.repeat(protos, 4, axis=1), 4, axis=2)
    kernel = np.ones((5,)) / 5.0
    for ax in (1, 2):
        up = np.apply_along_axis(
            lambda m: np.convolve(m, kernel, mode="same"), ax, up)
    up = up / (np.abs(up).max(axis=(1, 2, 3), keepdims=True) + 1e-9)
    return up.astype(np.float32)


def _sample(rng, protos, labels, spec: SynthSpec):
    """Prototype + random shift + noise for each label."""
    n = len(labels)
    x = protos[labels].copy()
    if spec.jitter > 0:
        sh = rng.integers(-spec.jitter, spec.jitter + 1, size=(n, 2))
        for i in range(n):
            x[i] = np.roll(x[i], sh[i], axis=(0, 1))
    x += rng.normal(scale=spec.noise, size=x.shape).astype(np.float32)
    return np.clip(x, -2.0, 2.0).astype(np.float32)


@dataclasses.dataclass
class ClusteredDataset:
    train_x: np.ndarray      # [n_nodes, N, H, W, C]
    train_y: np.ndarray      # [n_nodes, N]
    test_x: list             # per cluster: [M, H, W, C]
    test_y: list             # per cluster: [M]
    node_cluster: np.ndarray  # [n_nodes] true cluster id
    spec: SynthSpec
    transforms: tuple

    @property
    def n_nodes(self) -> int:
        return self.train_x.shape[0]

    @property
    def k(self) -> int:
        return len(self.test_x)


def make_clustered_data(spec: SynthSpec, cluster_sizes: Sequence[int],
                        transforms: Sequence[str] | None = None,
                        label_split: Sequence[Sequence[int]] | None = None
                        ) -> ClusteredDataset:
    """cluster_sizes e.g. (30, 2); transforms e.g. ("rot0", "rot180").

    ``label_split`` (Appendix G) restricts each cluster to a label subset
    (e.g. vehicles vs animals) instead of / in addition to feature skew.
    """
    k = len(cluster_sizes)
    if transforms is None:
        transforms = [f"rot{(i * 90) % 360}" for i in range(k)]
    assert len(transforms) == k
    rng = np.random.default_rng(spec.seed)
    protos = _prototypes(rng, spec)

    train_x, train_y, node_cluster = [], [], []
    for c, size in enumerate(cluster_sizes):
        allowed = (np.arange(spec.n_classes) if label_split is None
                   else np.asarray(label_split[c]))
        for _ in range(size):
            labels = np.repeat(allowed, spec.samples_per_class)
            rng.shuffle(labels)
            x = _sample(rng, protos, labels, spec)
            x = apply_transform(x, transforms[c])
            train_x.append(x)
            train_y.append(labels)
            node_cluster.append(c)

    test_x, test_y = [], []
    for c in range(k):
        allowed = (np.arange(spec.n_classes) if label_split is None
                   else np.asarray(label_split[c]))
        labels = np.repeat(allowed, spec.test_per_class)
        x = _sample(rng, protos, labels, spec)
        x = apply_transform(x, transforms[c])
        test_x.append(x.astype(np.float32))
        test_y.append(labels.astype(np.int32))

    return ClusteredDataset(
        train_x=np.stack(train_x), train_y=np.stack(train_y).astype(np.int32),
        test_x=test_x, test_y=test_y,
        node_cluster=np.asarray(node_cluster, np.int32),
        spec=spec, transforms=tuple(transforms))
