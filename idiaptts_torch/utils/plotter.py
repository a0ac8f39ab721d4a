"""DataPlotter: multi-grid matplotlib figures.  The port's copy of
``idiaptts_tpu/utils/plotter.py``: grid-indexed curves, spectrogram-style
images, shaded areas, annotations, atom spikes with their gamma curves,
a time axis in seconds, linked x-axes, context-manager use and
``save_to_file``.

matplotlib (with the Agg backend) is imported when a figure is drawn, so
importing this module, and every other module of the port, works without
it.
"""

import numpy as np


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


class DataPlotter:

    class Config:
        def __init__(self, plot_per_sec=None, f_get_emb_index=None,
                     **kwargs):
            self.plot_per_sec = plot_per_sec
            self.kwargs = kwargs

    def __init__(self, plot_per_sec=None):
        self.data_lists = {}
        self.image_data = {}
        self.areas = {}
        self.annotations = {}
        self.atom_lists = {}
        self.labels = {}
        self.limits = {}
        self.linestyles = {}
        self.colors = {}
        self.linewidths = {}
        self.hlines = {}
        self.title = None
        self.num_colors = 10
        self.fig = None
        # Frames per second: when set, the x axis is rendered in
        # seconds instead of frame indices.
        self.plot_per_sec = plot_per_sec

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()

    # -- configuration ----------------------------------------------------
    def set_data_list(self, grid_idx, data_list):
        """data_list: [(ydata, label[, xdata])] curves for one grid."""
        self.data_lists[grid_idx] = data_list

    def set_spec_data(self, grid_idx, spec, label=None):
        """(T, bins) spectrogram-style image."""
        self.image_data[grid_idx] = (np.asarray(spec), label)

    def set_area_list(self, grid_idx, area_list):
        """area_list: [(mask, color, alpha, label)]."""
        self.areas[grid_idx] = area_list

    def set_annotations(self, grid_idx, annotations):
        """annotations: [(x, y, text)]."""
        self.annotations[grid_idx] = annotations

    def set_atom_list(self, grid_idx, atom_list):
        """atom_list: objects with ``.position``, ``.amp`` and
        ``get_padded_curve(num_frames)`` (GammaAtom); each atom is
        drawn as an amplitude spike plus its gamma kernel curve
        (reference _plot_atom_list :426-434)."""
        self.atom_lists[grid_idx] = atom_list

    def set_label(self, grid_idx, xlabel=None, ylabel=None, title=None):
        self.labels[grid_idx] = (xlabel, ylabel, title)

    def set_lim(self, grid_idx, xmin=None, xmax=None, ymin=None,
                ymax=None):
        """Axis limits per grid (reference set_lim :162-205)."""
        self.limits[grid_idx] = (xmin, xmax, ymin, ymax)

    def set_linestyles(self, grid_idx, linestyles):
        self.linestyles[grid_idx] = list(linestyles)

    def set_colors(self, grid_idx, colors):
        self.colors[grid_idx] = list(colors) \
            if not isinstance(colors, str) else [colors]

    def set_linewidth(self, grid_idx, linewidth):
        self.linewidths[grid_idx] = list(linewidth) \
            if hasattr(linewidth, "__len__") else [linewidth]

    def set_hlines(self, grid_idx, hlines):
        """hlines: [(y, color, linestyle)] horizontal guide lines."""
        self.hlines[grid_idx] = hlines

    def set_title(self, title):
        self.title = title

    def set_num_colors(self, num):
        self.num_colors = num

    # -- rendering --------------------------------------------------------
    def _max_length(self, grid_idx):
        length = 0
        for entry in self.data_lists.get(grid_idx, []):
            length = max(length, len(entry[0]))
        if grid_idx in self.image_data:
            length = max(length, len(self.image_data[grid_idx][0]))
        for atom in self.atom_lists.get(grid_idx, []):
            length = max(length, atom.position + 1)
        for mask, _, _, _ in self.areas.get(grid_idx, []):
            length = max(length, len(np.atleast_1d(mask)))
        return length

    def _times(self, length):
        t = np.arange(length, dtype=np.float64)
        if self.plot_per_sec:
            t = t / float(self.plot_per_sec)
        return t

    def gen_plot(self, sharex=True, figsize=None):
        grids = sorted(set(list(self.data_lists)
                           + list(self.image_data)
                           + list(self.atom_lists)
                           + list(self.areas)))
        if not grids:
            raise ValueError("No data set.")
        n = len(grids)
        plt = _pyplot()
        self.fig, axes = plt.subplots(
            n, 1, sharex=sharex, squeeze=False,
            figsize=figsize or (10, 2.5 * n))
        for ax, grid_idx in zip(axes[:, 0], grids):
            max_length = self._max_length(grid_idx)
            if grid_idx in self.image_data:
                spec, label = self.image_data[grid_idx]
                extent = None
                if self.plot_per_sec:
                    extent = (0, len(spec) / float(self.plot_per_sec),
                              0, spec.shape[1])
                ax.imshow(spec.T, aspect="auto", origin="lower",
                          interpolation="none", extent=extent)
                if label:
                    ax.set_title(label)
            styles = self.linestyles.get(grid_idx, [])
            colors = self.colors.get(grid_idx, [])
            widths = self.linewidths.get(grid_idx, [])
            for k, entry in enumerate(self.data_lists.get(grid_idx,
                                                          [])):
                ydata, label = entry[0], entry[1] if len(entry) > 1 \
                    else None
                xdata = entry[2] if len(entry) > 2 else \
                    self._times(len(ydata))
                kwargs = {}
                if k < len(styles):
                    kwargs["linestyle"] = styles[k]
                if k < len(colors):
                    kwargs["color"] = colors[k]
                ax.plot(xdata, ydata, label=label,
                        linewidth=widths[k] if k < len(widths)
                        else 0.8, **kwargs)
            for hline in self.hlines.get(grid_idx, []):
                y = hline[0]
                ax.axhline(y, color=hline[1] if len(hline) > 1
                           else "0.5",
                           linestyle=hline[2] if len(hline) > 2
                           else "--", linewidth=0.6)
            atoms = self.atom_lists.get(grid_idx, [])
            if atoms:
                t = self._times(max_length)
                spikes = np.zeros(max_length)
                for atom in atoms:
                    spikes[min(atom.position, max_length - 1)] = atom.amp
                    ax.plot(t, atom.get_padded_curve(max_length),
                            linewidth=1.2)
                markerline, _, _ = ax.stem(t, spikes)
                plt.setp(markerline, markersize=2)
            for mask, color, alpha, label in self.areas.get(grid_idx,
                                                            []):
                ax.fill_between(self._times(len(mask)), 0, 1,
                                where=np.asarray(mask) > 0,
                                color=color, alpha=alpha,
                                transform=ax.get_xaxis_transform(),
                                label=label)
            for x, y, text in self.annotations.get(grid_idx, []):
                ax.annotate(text, (x, y))
            xlabel, ylabel, title = self.labels.get(grid_idx,
                                                    (None, None, None))
            if xlabel is None and self.plot_per_sec:
                xlabel = "time (s)"
            if xlabel:
                ax.set_xlabel(xlabel)
            if ylabel:
                ax.set_ylabel(ylabel)
            if title:
                ax.set_title(title)
            xmin, xmax, ymin, ymax = self.limits.get(
                grid_idx, (None, None, None, None))
            if xmin is not None or xmax is not None:
                ax.set_xlim(left=xmin, right=xmax)
            if ymin is not None or ymax is not None:
                ax.set_ylim(bottom=ymin, top=ymax)
            if self.data_lists.get(grid_idx):
                ax.legend(loc="upper right", fontsize="x-small")
        if self.title:
            self.fig.suptitle(self.title)
        self.fig.tight_layout()
        return self.fig

    def save_to_file(self, file_path):
        if self.fig is None:
            self.gen_plot()
        self.fig.savefig(file_path)
        return file_path

    def show(self):
        if self.fig is not None:
            self.fig.show()

    def close(self):
        if self.fig is not None:
            _pyplot().close(self.fig)
            self.fig = None
