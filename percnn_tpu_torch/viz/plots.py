"""Comparison panels, the Stage-2 Pareto figure and 3D isosurface export.

Counterpart of percnn_tpu/viz/plots.py, with its file names, layouts,
titles and colour maps: the reference's per-script postProcess panels of
prediction / truth / measurement / error (percnn_LO_eqn.py:400-462,
train_2drd.py:445-572) and its plotly isosurface viewer (Plot3D.py:6-29).
The figures are drawn on ``matplotlib.figure.Figure`` with the Agg canvas,
without pyplot, so no global backend is switched.  ``frame_series`` builds
its figure and colorbars once and redraws it frame by frame with new data
and colour limits, where the JAX version builds a figure a frame.
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np


def _figure(nrows: int, ncols: int, figsize):
    from matplotlib.figure import Figure

    fig = Figure(figsize=figsize)
    return fig, fig.subplots(nrows, ncols, squeeze=False)


class _Panel:
    """A C x 3 grid of images with a colorbar each, updated in place."""

    def __init__(self, C: int, figsize, cmap: str, *, ticks_off: str):
        self.fig, self.axes = _figure(C, 3, figsize)
        self.ims = [[None] * 3 for _ in range(C)]
        self.cmap = cmap
        self.ticks_off = ticks_off
        self.title = None

    def set(self, fields, names, lims, title: str, *, colorbar_kw: dict, fontsize: int):
        """fields[c][j], names[c][j]; lims[c][j] (vmin, vmax) or None to fit
        the field."""
        for c, row in enumerate(fields):
            for j, field in enumerate(row):
                lo, hi = lims[c][j] if lims[c][j] is not None else (None, None)
                ax = self.axes[c][j]
                im = self.ims[c][j]
                if im is None:
                    im = ax.imshow(field, cmap=self.cmap, vmin=lo, vmax=hi)
                    if self.ticks_off == "axis":
                        ax.axis("off")
                    else:
                        ax.set_xticks([])
                        ax.set_yticks([])
                    self.fig.colorbar(im, ax=ax, **colorbar_kw)
                    self.ims[c][j] = im
                else:
                    im.set_data(field)
                    if lo is None:
                        im.autoscale()
                    else:
                        im.set_clim(lo, hi)
                ax.set_title(names[c][j], fontsize=fontsize)
        if title:
            if self.title is None:
                self.title = self.fig.suptitle(title)
            else:
                self.title.set_text(title)


def _comparison(panel: _Panel | None, pred, truth, channel_names, title) -> _Panel:
    C = pred.shape[-1]
    if panel is None:
        panel = _Panel(C, (10, 3 * C), "jet", ticks_off="axis")
        first = True
    else:
        first = False
    fields, names, lims = [], [], []
    for c in range(C):
        vmin = min(pred[..., c].min(), truth[..., c].min())
        vmax = max(pred[..., c].max(), truth[..., c].max())
        fields.append([pred[..., c], truth[..., c], np.abs(pred[..., c] - truth[..., c])])
        names.append([f"{channel_names[c]} pred", f"{channel_names[c]} truth",
                      f"{channel_names[c]} |err|"])
        lims.append([(vmin, vmax), (vmin, vmax), None])
    panel.set(fields, names, lims, title, colorbar_kw={"fraction": 0.046}, fontsize=9)
    if first:
        panel.fig.tight_layout()
    return panel


def comparison_panel(pred: np.ndarray, truth: np.ndarray, path: str, *,
                     channel_names=("u", "v"), title: str = ""):
    """Side-by-side pred / truth / |error| images for each channel.

    pred/truth: [H, W, C] single frames.
    """
    _comparison(None, pred, truth, channel_names, title).fig.savefig(path, dpi=150)


def ic_panel(isg_out: np.ndarray, target: np.ndarray, path: str,
             low_res: np.ndarray | None = None):
    """ISG output vs interpolation target (the reference's plot_IC,
    rcnn_Burgers...py:489-578), optionally with the raw low-res noisy
    measurement as a third diagnostic column."""
    if low_res is None:
        comparison_panel(isg_out, target, path, title="initial state: ISG vs interp")
        return
    measurement_panel(isg_out, target, low_res, path,
                      col_names=("ISG", "interp target", "measurement"),
                      title="initial state: ISG vs interp vs measurement")


def _measurement(panel: _Panel | None, pred, truth, meas_low, channel_names, col_names,
                 vlims, title) -> _Panel:
    C = pred.shape[-1]
    if panel is None:
        panel = _Panel(C, (11, 3.5 * C), "hot", ticks_off="ticks")
        panel.fig.subplots_adjust(hspace=0.25, wspace=0.25)
    scale = max(1, pred.shape[0] // meas_low.shape[0])
    fields, names, lims = [], [], []
    for c in range(C):
        if vlims is not None:
            vmin, vmax = vlims[c]
        else:
            vmin = min(pred[..., c].min(), truth[..., c].min())
            vmax = max(pred[..., c].max(), truth[..., c].max())
        fields.append([pred[..., c], truth[..., c],
                       np.kron(meas_low[..., c], np.ones((scale, scale)))])
        names.append([f"{channel_names[c]} ({n})" for n in col_names])
        lims.append([(vmin, vmax)] * 3)
    panel.set(fields, names, lims, title, colorbar_kw={"fraction": 0.046, "pad": 0.04},
              fontsize=10)
    return panel


def measurement_panel(pred: np.ndarray, truth: np.ndarray, meas_low: np.ndarray, path: str,
                      *, channel_names=("u", "v"), col_names=("PeRCNN", "Ref.", "Meas."),
                      vlims=None, title: str = ""):
    """The reference's 2x3 postProcess panel with the noisy-measurement
    column (train_2drd.py:445-521 postProcess_2x3): per channel, columns
    prediction / clean truth / low-res measurement.  The measurement is
    nearest-upsampled (np.kron of ones, as the reference) to the
    prediction's grid.

    pred/truth: [H, W, C]; meas_low: [h, w, C] (h <= H).
    vlims: optional per-channel (vmin, vmax) list (the reference pins u/v
    in [0, 1] for GS); None = the shared min/max of pred and truth.
    """
    panel = _measurement(None, pred, truth, meas_low, channel_names, col_names, vlims, title)
    panel.fig.savefig(path, dpi=150, bbox_inches="tight")


def pareto_panel(gammas, ls_loss, l0_count, path: str, *,
                 selected_gamma: float | None = None, eq: str = "u"):
    """Pareto-front gamma-sweep figure, the reference's select_gamma_u.png
    (LO stage-2 PDE_FIND_u.py:297-335): regression error and L0 count on
    twin y-axes over a log-scale gamma axis, with the knee that
    pareto_select picked marked (the reference picks gamma by eye from
    this plot)."""
    gammas = np.asarray(gammas, dtype=float)
    fig, axes = _figure(1, 1, (7.0, 4.5))
    ax1 = axes[0][0]
    fig.subplots_adjust(bottom=0.2)
    ax1.plot(gammas, np.asarray(ls_loss, dtype=float), marker="o",
             markersize=4, color="dodgerblue", label="regression error")
    ax1.set_xscale("log")
    ax1.set_xlabel(r"$\gamma$", fontsize=14)
    ax1.set_ylabel(r"$\|\Phi\,\Xi - Z\|_2$", color="dodgerblue", fontsize=13)
    ax1.tick_params(axis="y", colors="dodgerblue", direction="in")
    ax2 = ax1.twinx()
    ax2.plot(gammas, np.asarray(l0_count, dtype=float), marker="o",
             markersize=4, color="orangered", label=r"$\ell_0$ count")
    ax2.set_ylabel(r"$\|\Xi\|_0$", color="orangered", fontsize=13)
    ax2.tick_params(axis="y", colors="orangered", direction="in")
    if selected_gamma is not None:
        ax1.axvline(float(selected_gamma), color="gray", linestyle="--", linewidth=1.2)
        ax1.annotate(f"knee $\\gamma$={float(selected_gamma):.3g}",
                     xy=(float(selected_gamma), max(np.asarray(ls_loss))),
                     fontsize=10, color="gray", ha="left")
    fig.suptitle(f"Stage-2 Pareto sweep ({eq}-equation)", fontsize=12)
    fig.savefig(path, dpi=150, bbox_inches="tight")
    return path


class _FrameWriter:
    """Renders a figure that is redrawn frame by frame onto one Agg canvas
    and writes each frame's PNG on a worker thread while the next frame is
    drawn.  With ``tight``, each frame is cropped to the figure's tight
    bounding box padded by ``savefig.pad_inches``, which is what
    ``savefig(bbox_inches="tight")`` keeps."""

    def __init__(self, fig, dpi: int, tight: bool):
        import concurrent.futures

        from matplotlib.backends.backend_agg import FigureCanvasAgg

        fig.set_dpi(dpi)
        self.fig = fig
        self.canvas = FigureCanvasAgg(fig)
        self.tight = tight
        self.pool = concurrent.futures.ThreadPoolExecutor(1)
        self.pending = []
        self.box = None

    def _crop(self, buf: np.ndarray) -> np.ndarray:
        """The first frame's tight box, kept for the rest: the layout does
        not move between frames."""
        if self.box is None:
            import matplotlib

            pad = matplotlib.rcParams["savefig.pad_inches"]
            box = self.fig.get_tightbbox(self.canvas.get_renderer()).padded(pad)
            dpi, h, w = self.fig.dpi, buf.shape[0], buf.shape[1]
            self.box = (slice(max(0, int(round(h - box.y1 * dpi))),
                              min(h, int(round(h - box.y0 * dpi)))),
                        slice(max(0, int(round(box.x0 * dpi))), min(w, int(round(box.x1 * dpi)))))
        return buf[self.box]

    def write(self, path: str) -> None:
        from PIL import Image

        self.canvas.draw()
        buf = np.array(self.canvas.buffer_rgba())
        if self.tight:
            buf = self._crop(buf)
        self.pending.append(self.pool.submit(
            lambda: Image.fromarray(buf).save(path, compress_level=1)))

    def close(self) -> None:
        self.pool.shutdown(wait=True)
        for f in self.pending:
            f.result()


def frame_series(frames: np.ndarray, truth: np.ndarray, out_dir: str, *,
                 name: str = "uv_comparison", every: int | None = None,
                 max_frames: int = 25, meas_low: np.ndarray | None = None) -> list:
    """The comparison panel for a stride of time steps, the reference's
    ``for i in range(0, steps, 10): postProcess(...)`` image series
    (percnn_LO_eqn.py:526-543, files uv_comparison_NNN.png).

    frames/truth: [T, H, W, C]; meas_low: optional [T_m, h, w, C] adds the
    measurement column for the nearest measurement frame.  One figure is
    built and redrawn for each frame, and the PNGs are written at the
    fastest zlib level.  Returns the written paths."""
    os.makedirs(out_dir, exist_ok=True)
    T = min(frames.shape[0], truth.shape[0])
    if every is None:
        every = max(1, T // max_frames)
    paths = []
    panel = writer = None
    try:
        for t in range(0, T, every):
            if meas_low is not None:
                tm = min(int(round(t / max(1, (T - 1)) * (meas_low.shape[0] - 1))),
                         meas_low.shape[0] - 1)
                panel = _measurement(panel, frames[t], truth[t], meas_low[tm], ("u", "v"),
                                     ("PeRCNN", "Ref.", "Meas."), None, f"t={t}")
            else:
                panel = _comparison(panel, frames[t], truth[t], ("u", "v"), f"t={t}")
            if writer is None:
                writer = _FrameWriter(panel.fig, 150, tight=meas_low is not None)
            paths.append(os.path.join(out_dir, f"{name}_{t:03d}.png"))
            writer.write(paths[-1])
    finally:
        if writer is not None:
            writer.close()
    return paths


def isosurface_pair(pred_vol: np.ndarray, truth_vol: np.ndarray, path_prefix: str, *,
                    channel_names=("u", "v"), level_fracs=(0.5, 0.5)) -> list:
    """u and v isosurfaces for prediction and truth, the four files the
    reference exports (Plot3D.py:6-29, Iso_surf_{u,v}_{PeRCNN,Truth}_N).

    pred_vol/truth_vol: [D, H, W, C].  Writes
    {path_prefix}.{u,v}.{pred,truth}.html (or a .png montage without
    plotly) and returns the paths written."""
    paths = []
    for c, cname in enumerate(channel_names[: pred_vol.shape[-1]]):
        for vol, tag in ((pred_vol, "pred"), (truth_vol, "truth")):
            paths.append(save_isosurface_html(vol[..., c], f"{path_prefix}.{cname}.{tag}.html",
                                              level_frac=level_fracs[c]))
    return paths


def save_isosurface_html(field: np.ndarray, path: str, *, level_frac: float = 0.5) -> str:
    """3D isosurface of a [D, H, W] scalar field with plotly (the
    reference's Plot3D.py); without plotly, a montage of the three
    mid-slices at ``path`` with ``.png`` for ``.html``.  Returns the path
    written."""
    if importlib.util.find_spec("plotly") is not None:
        import plotly.graph_objects as go

        d, h, w = field.shape
        X, Y, Z = np.mgrid[0:d, 0:h, 0:w]
        level = field.min() + level_frac * (field.max() - field.min())
        fig = go.Figure(go.Isosurface(
            x=X.ravel(), y=Y.ravel(), z=Z.ravel(), value=field.ravel(),
            isomin=level, isomax=level, surface_count=1, opacity=0.6,
        ))
        fig.write_html(path)
        return path
    fig, axes = _figure(1, 3, (12, 4))
    for ax, (sl, name) in zip(axes[0], [
        (field[field.shape[0] // 2], "z-mid"),
        (field[:, field.shape[1] // 2], "y-mid"),
        (field[:, :, field.shape[2] // 2], "x-mid"),
    ]):
        ax.imshow(sl, cmap="jet")
        ax.set_title(name)
        ax.axis("off")
    png = path.replace(".html", ".png")
    fig.savefig(png, dpi=150)
    return png
