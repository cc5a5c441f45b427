"""Matplotlib result plots, written at the end of a run.

Counterpart of ``hydragnn_tpu/postprocess/visualizer.py`` (seven plot
methods, the ``Agg`` backend, the same file names under
``logs/<name>/``), which ``runner.run_training`` drives when the config's
``Visualization.create_plots`` is true. Every method takes host (numpy)
arrays; the caller moves tensors off the device first.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402


class Visualizer:
    def __init__(
        self,
        model_with_config_name: str,
        node_feature: Optional[list] = None,
        num_heads: int = 1,
        head_dims: Optional[Sequence[int]] = None,
    ):
        self.name = model_with_config_name
        self.num_heads = num_heads
        self.head_dims = list(head_dims or [1] * num_heads)
        self.outdir = os.path.join("logs", self.name)
        os.makedirs(self.outdir, exist_ok=True)

    def create_scatter_plots(
        self,
        true_values: List[np.ndarray],
        predicted_values: List[np.ndarray],
        output_names: Optional[Sequence[str]] = None,
    ) -> None:
        """Predicted vs true per head, with the y=x diagonal and RMSE in
        the title (reference visualizer scatter plots)."""
        for h, (t, p) in enumerate(zip(true_values, predicted_values)):
            t = np.asarray(t).reshape(-1)
            p = np.asarray(p).reshape(-1)
            name = (
                output_names[h]
                if output_names and h < len(output_names)
                else f"head{h}"
            )
            fig, ax = plt.subplots(figsize=(5, 5))
            ax.scatter(t, p, s=6, alpha=0.5, edgecolors="none")
            lo = float(min(t.min(), p.min())) if t.size else 0.0
            hi = float(max(t.max(), p.max())) if t.size else 1.0
            ax.plot([lo, hi], [lo, hi], "k--", lw=1)
            rmse = float(np.sqrt(np.mean((t - p) ** 2))) if t.size else 0.0
            ax.set_xlabel("true")
            ax.set_ylabel("predicted")
            ax.set_title(f"{name} (RMSE {rmse:.4g})")
            fig.tight_layout()
            fig.savefig(os.path.join(self.outdir, f"scatter_{name}.png"))
            plt.close(fig)

    def plot_history(
        self,
        train_loss: Sequence[float],
        val_loss: Sequence[float],
        test_loss: Optional[Sequence[float]] = None,
    ) -> None:
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.plot(train_loss, label="train")
        ax.plot(val_loss, label="val")
        if test_loss is not None:
            ax.plot(test_loss, label="test")
        ax.set_xlabel("epoch")
        ax.set_ylabel("loss")
        ax.set_yscale("log")
        ax.legend()
        fig.tight_layout()
        fig.savefig(os.path.join(self.outdir, "history.png"))
        plt.close(fig)

    def num_nodes_plot(self, datasets: Sequence, split_names=None) -> None:
        """Node-count histograms per split (reference visualizer)."""
        split_names = split_names or [f"split{i}" for i in range(len(datasets))]
        fig, ax = plt.subplots(figsize=(6, 4))
        for ds, nm in zip(datasets, split_names):
            counts = [s.num_nodes for s in ds]
            ax.hist(counts, bins=20, alpha=0.5, label=nm)
        ax.set_xlabel("nodes per graph")
        ax.set_ylabel("count")
        ax.legend()
        fig.tight_layout()
        fig.savefig(os.path.join(self.outdir, "num_nodes.png"))
        plt.close(fig)

    # ------------------------------------------------------------------
    # Parity-depth plots (reference postprocess/visualizer.py:134-612)
    # ------------------------------------------------------------------

    def create_error_histograms(
        self,
        true_values: List[np.ndarray],
        predicted_values: List[np.ndarray],
        output_names: Optional[Sequence[str]] = None,
    ) -> None:
        """Per-head error histogram (reference
        create_parity_plot_and_error_histogram_scalar,
        visualizer.py:281-385: parity panel + |err| histogram panel)."""
        for h, (t, p) in enumerate(zip(true_values, predicted_values)):
            t = np.asarray(t).reshape(-1)
            p = np.asarray(p).reshape(-1)
            if not t.size:
                continue
            name = (
                output_names[h]
                if output_names and h < len(output_names)
                else f"head{h}"
            )
            err = p - t
            fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4.5))
            ax1.scatter(t, p, s=6, alpha=0.5, edgecolors="none")
            lo, hi = float(min(t.min(), p.min())), float(
                max(t.max(), p.max())
            )
            ax1.plot([lo, hi], [lo, hi], "k--", lw=1)
            mae = float(np.abs(err).mean())
            rmse = float(np.sqrt((err**2).mean()))
            ax1.set_xlabel("true")
            ax1.set_ylabel("predicted")
            ax1.set_title(f"{name} parity")
            ax2.hist(err, bins=40)
            ax2.set_xlabel("prediction error")
            ax2.set_ylabel("count")
            ax2.set_title(f"MAE {mae:.4g}  RMSE {rmse:.4g}")
            fig.tight_layout()
            fig.savefig(
                os.path.join(self.outdir, f"error_hist_{name}.png")
            )
            plt.close(fig)

    def create_plot_global(
        self,
        true_values: List[np.ndarray],
        predicted_values: List[np.ndarray],
        output_names: Optional[Sequence[str]] = None,
    ) -> None:
        """One grid figure over all heads: 2-D density of (true, pred)
        plus the conditional mean error vs true (reference
        create_plot_global_analysis, visualizer.py:134-279)."""
        n = len(true_values)
        if n == 0:
            return
        fig, axes = plt.subplots(2, n, figsize=(4.6 * n, 8), squeeze=False)
        for h, (t, p) in enumerate(zip(true_values, predicted_values)):
            t = np.asarray(t).reshape(-1)
            p = np.asarray(p).reshape(-1)
            name = (
                output_names[h]
                if output_names and h < len(output_names)
                else f"head{h}"
            )
            ax = axes[0][h]
            if t.size > 1:
                hb = ax.hexbin(t, p, gridsize=40, mincnt=1, cmap="viridis")
                fig.colorbar(hb, ax=ax, shrink=0.8)
                lo, hi = float(min(t.min(), p.min())), float(
                    max(t.max(), p.max())
                )
                ax.plot([lo, hi], [lo, hi], "w--", lw=1)
            ax.set_title(name)
            ax.set_xlabel("true")
            ax.set_ylabel("predicted")
            # Conditional mean |error| over binned true values.
            ax2 = axes[1][h]
            if t.size > 1:
                bins = np.linspace(t.min(), t.max(), 21)
                idx = np.clip(np.digitize(t, bins) - 1, 0, 19)
                err = np.abs(p - t)
                means = np.array(
                    [
                        err[idx == b].mean() if (idx == b).any() else np.nan
                        for b in range(20)
                    ]
                )
                ax2.plot(0.5 * (bins[:-1] + bins[1:]), means, "o-")
            ax2.set_xlabel("true")
            ax2.set_ylabel("mean |error|")
        fig.tight_layout()
        fig.savefig(os.path.join(self.outdir, "global_analysis.png"))
        plt.close(fig)

    def create_parity_plot_vector(
        self,
        true_vec: np.ndarray,
        pred_vec: np.ndarray,
        name: str = "forces",
    ) -> None:
        """Vector-output parity: one panel per component + magnitude
        (reference create_parity_plot_vector /
        create_parity_plot_per_node_vector, visualizer.py:467-612)."""
        t = np.asarray(true_vec)
        p = np.asarray(pred_vec)
        if t.ndim != 2 or not t.size:
            return
        d = t.shape[1]
        labels = (
            ["x", "y", "z"][:d] if d <= 3 else [str(i) for i in range(d)]
        )
        fig, axes = plt.subplots(1, d + 1, figsize=(4.2 * (d + 1), 4))
        for c in range(d):
            ax = axes[c]
            ax.scatter(t[:, c], p[:, c], s=4, alpha=0.4, edgecolors="none")
            lo = float(min(t[:, c].min(), p[:, c].min()))
            hi = float(max(t[:, c].max(), p[:, c].max()))
            ax.plot([lo, hi], [lo, hi], "k--", lw=1)
            ax.set_title(f"{name} {labels[c]}")
            ax.set_xlabel("true")
            ax.set_ylabel("predicted")
        tm = np.linalg.norm(t, axis=1)
        pm = np.linalg.norm(p, axis=1)
        ax = axes[d]
        ax.scatter(tm, pm, s=4, alpha=0.4, edgecolors="none")
        hi = float(max(tm.max(), pm.max()))
        ax.plot([0, hi], [0, hi], "k--", lw=1)
        mae = float(np.abs(p - t).mean())
        ax.set_title(f"|{name}| (MAE {mae:.4g})")
        ax.set_xlabel("true")
        ax.set_ylabel("predicted")
        fig.tight_layout()
        fig.savefig(os.path.join(self.outdir, f"parity_{name}.png"))
        plt.close(fig)

    def plot_task_history(
        self,
        task_histories: Sequence[np.ndarray],
        task_names: Optional[Sequence[str]] = None,
    ) -> None:
        """Per-task loss curves over epochs (reference plot_history's
        per-head panels, visualizer.py:629-690)."""
        if not len(task_histories):
            return
        arr = np.stack([np.asarray(t).reshape(-1) for t in task_histories])
        n_tasks = arr.shape[1]
        names = list(task_names or [f"task{i}" for i in range(n_tasks)])
        fig, ax = plt.subplots(figsize=(6, 4))
        for i in range(n_tasks):
            ax.plot(arr[:, i], label=names[i] if i < len(names) else str(i))
        ax.set_xlabel("epoch")
        ax.set_ylabel("task loss")
        ax.set_yscale("log")
        ax.legend()
        fig.tight_layout()
        fig.savefig(os.path.join(self.outdir, "task_history.png"))
        plt.close(fig)
