"""Matplotlib Agg heatmap dumps (the port's own copy of
``msmctts_tpu/utils/plot.py``). matplotlib is imported at the call."""

from __future__ import annotations

import numpy as np


def plot_matrix(matrix, filename: str):
    """Save a [D, T] matrix (or [N, D, T] grid) as a heatmap PNG."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    matrix = np.asarray(matrix)
    if matrix.ndim == 2:
        fig, ax = plt.subplots(figsize=(10, 4))
        im = ax.imshow(matrix, aspect="auto", origin="lower", interpolation="none")
        fig.colorbar(im, ax=ax)
    else:
        n = matrix.shape[0]
        fig, axes = plt.subplots(n, 1, figsize=(10, 3 * n))
        axes = np.atleast_1d(axes)
        for i in range(n):
            im = axes[i].imshow(matrix[i], aspect="auto", origin="lower", interpolation="none")
            fig.colorbar(im, ax=axes[i])
    fig.tight_layout()
    fig.savefig(filename)
    plt.close(fig)
