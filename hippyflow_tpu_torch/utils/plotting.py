"""Spectrum and accuracy plots (numpy/matplotlib copy of
``hippyflow_tpu/utils/plotting.py``).

matplotlib is optional and imported only inside the functions.  Where it
is not installed, each entry point logs one line saying so, writes
nothing and returns None.  Any other error (an unwritable path, a bad
array) raises.
"""

from __future__ import annotations

import logging
import os

import numpy as np

_log = logging.getLogger(__name__)


def _plt(what: str):
    """matplotlib.pyplot on the Agg backend, or None (logged) where
    matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError:
        _log.warning("matplotlib is not installed: %s not plotted", what)
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _finish(fig, ax, plt, axis_label, out_name):
    ax.set_xlabel(axis_label[0])
    ax.set_ylabel(axis_label[1])
    if len(axis_label) > 2:
        ax.set_title(axis_label[2])
    if out_name:
        fig.savefig(out_name, bbox_inches="tight")
    plt.close(fig)
    return fig


def spectrum_plot(d, axis_label=("i", "lambda_i", "spectrum"), out_name=None,
                  show=False):
    """Semilog eigenvalue decay plot."""
    plt = _plt(out_name or "spectrum")
    if plt is None:
        return None
    fig, ax = plt.subplots()
    d = np.asarray(d)
    ax.semilogy(np.arange(1, len(d) + 1), np.maximum(d, 1e-300), "o-")
    return _finish(fig, ax, plt, axis_label, out_name)


def generic_semilogy_plot(xs, ys, labels=None, axis_label=("x", "y", ""),
                          out_name=None):
    plt = _plt(out_name or "semilogy plot")
    if plt is None:
        return None
    fig, ax = plt.subplots()
    for i, y in enumerate(np.atleast_2d(ys)):
        ax.semilogy(xs, y, "o-", label=labels[i] if labels else None)
    if labels:
        ax.legend()
    return _finish(fig, ax, plt, axis_label, out_name)


def plot_accs_vs_data(data_sizes, accs, labels=None, out_name=None):
    """Accuracy-vs-training-data-count curves."""
    plt = _plt(out_name or "accuracy plot")
    if plt is None:
        return None
    fig, ax = plt.subplots()
    for i, a in enumerate(np.atleast_2d(np.asarray(accs))):
        ax.semilogx(data_sizes, a, "o-", label=labels[i] if labels else None)
    if labels:
        ax.legend()
    return _finish(fig, ax, plt, ("training data", "accuracy"), out_name)


def plot_singular_values_with_std(s_mean, s_std, axis_label=("i", "sigma_i", ""),
                                  out_name=None):
    """Mean singular-value decay with a +/- std band."""
    plt = _plt(out_name or "singular values")
    if plt is None:
        return None
    fig, ax = plt.subplots()
    s_mean, s_std = np.asarray(s_mean), np.asarray(s_std)
    idx = np.arange(1, len(s_mean) + 1)
    ax.semilogy(idx, np.maximum(s_mean, 1e-300), "o-")
    ax.fill_between(idx, np.maximum(s_mean - s_std, 1e-300), s_mean + s_std,
                    alpha=0.3)
    return _finish(fig, ax, plt, axis_label, out_name)


def subspace_angle_video(bases, out_name="subspace_angles.mp4", fps=2):
    """Principal-angle evolution between successive bases.  Saves an mp4
    where matplotlib finds ffmpeg, else a per-frame png series next to
    ``out_name`` (returns its stem)."""
    if len(bases) < 2:
        return None
    plt = _plt(out_name)
    if plt is None:
        return None
    import matplotlib.animation as manim

    def angles(U, V):
        s = np.linalg.svd(np.asarray(U).T @ np.asarray(V), compute_uv=False)
        return np.degrees(np.arccos(np.clip(s, -1.0, 1.0)))

    frames = [angles(bases[i], bases[i + 1]) for i in range(len(bases) - 1)]
    fig, ax = plt.subplots()

    def draw(i, f):
        ax.clear()
        ax.plot(f, "o-")
        ax.set_ylim(0, 90)
        ax.set_xlabel("mode")
        ax.set_ylabel("principal angle (deg)")
        ax.set_title(f"frame {i}")

    if manim.writers.is_available("ffmpeg"):
        writer = manim.FFMpegWriter(fps=fps)
        with writer.saving(fig, out_name, dpi=100):
            for i, f in enumerate(frames):
                draw(i, f)
                writer.grab_frame()
        plt.close(fig)
        return out_name
    base, _ = os.path.splitext(out_name)
    for i, f in enumerate(frames):
        draw(i, f)
        fig.savefig(f"{base}_{i:04d}.png", bbox_inches="tight")
    plt.close(fig)
    return base


def plot(space, vec, out_name=None, **kwargs):
    """2D FE field triplot."""
    return plot_eigenvector(space, vec, out_name=out_name)


def plot_pts(points, values=None, out_name=None):
    """Scatter of observation targets."""
    plt = _plt(out_name or "points")
    if plt is None:
        return None
    fig, ax = plt.subplots()
    points = np.asarray(points)
    sc = ax.scatter(points[:, 0], points[:, 1],
                    c=None if values is None else np.asarray(values))
    if values is not None:
        fig.colorbar(sc)
    ax.set_aspect("equal")
    if out_name:
        fig.savefig(out_name, bbox_inches="tight")
    plt.close(fig)
    return fig


def plot_eigenvector(space, vec, out_name=None):
    """Triplot render of a P1 field on ``space``'s mesh."""
    plt = _plt(out_name or "field")
    if plt is None:
        return None
    import matplotlib.tri as mtri

    mesh = space.mesh
    tri = mtri.Triangulation(mesh.vertices[:, 0], mesh.vertices[:, 1], mesh.cells)
    fig, ax = plt.subplots()
    tc = ax.tripcolor(tri, np.asarray(vec), shading="gouraud")
    fig.colorbar(tc)
    ax.set_aspect("equal")
    if out_name:
        fig.savefig(out_name, bbox_inches="tight")
    plt.close(fig)
    return fig
