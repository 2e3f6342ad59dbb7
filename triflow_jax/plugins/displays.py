"""Real-time display plugin.

Reference analog: TriflowDisplay (upstream triflow/plugins/
displays.py:43-142) — live plots of the 1D fields or of a scalar probe fed
from the simulation stream, with optional per-frame on-disk snapshots.

Implementation differences: holoviews/bokeh are replaced by matplotlib with
the headless Agg backend (the reference itself falls back to Agg when no
display is found, displays.py:24-36); frames are written synchronously rather
than via one spawned process per frame (displays.py:58-67) — the snapshot
path is off the numerical loop either way.
"""

from __future__ import annotations

import logging
import os
import warnings
from collections import deque
from pathlib import Path
from uuid import uuid4

import numpy as np

logger = logging.getLogger(__name__)
logger.addHandler(logging.NullHandler())


def is_interactive():
    import __main__ as main

    return not hasattr(main, "__file__")


def _load_matplotlib():
    import matplotlib as mpl

    if os.environ.get("DISPLAY", "") == "":
        logger.info("no display found; using non-interactive Agg backend")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            mpl.use("Agg")
    import matplotlib.pyplot as plt

    return plt


class Display:
    """Stream-fed live plot with optional on-disk frame capture.

    Parameters
    ----------
    skel_data : the simulation (used to draw the initial frame)
    plot_function : callable(simul, fig) -> None, redraws the figure
    on_disk : str or None — directory to write one image per emitted frame
    on_disk_name : str — frame basename; files are ``<name>_<i>.<fmt>``
    fmt : str — image format (png/svg/pdf), default png
    every : int — redraw every n-th emitted frame (1: every frame)
    asynchronous : bool — draw on a worker thread holding only the LATEST
        pending frame (the live-view semantics of the reference's holoviews
        Pipe/DynamicMap, displays.py:43-73): a slow plot_function then
        drops intermediate frames instead of stalling the time loop.  Call
        :meth:`close` to drain the final frame.
    live : bool or None — self-updating in-notebook view: the figure is
        published through an IPython display handle and every redrawn frame
        replaces it IN PLACE, so the notebook cell shows the simulation
        progressing as the loop runs — the notebook-facing behavior of the
        reference's ``DynamicMap``/``Pipe`` display (displays.py:43-73).
        ``None`` (default) auto-enables inside an IPython kernel with a
        display; ``False`` disables.
    """

    def __init__(self, skel_data, plot_function, on_disk=None,
                 on_disk_name="triflow_plot", fmt="png", every=1,
                 asynchronous=False, live=None, **renderer_args):
        self._plt = _load_matplotlib()
        self._plot_function = plot_function
        self.on_disk = on_disk
        self._on_disk_name = on_disk_name
        self._fmt = fmt
        self._renderer_args = renderer_args
        if asynchronous:
            # the worker thread renders the figure: GUI backends (Tk/Qt)
            # forbid drawing off the main thread, so the async path uses a
            # standalone Agg figure decoupled from any pyplot event loop
            # (off-screen rendering; frames still reach on_disk)
            from matplotlib.backends.backend_agg import FigureCanvasAgg
            from matplotlib.figure import Figure

            self._fig = Figure()
            FigureCanvasAgg(self._fig)
        else:
            self._fig = self._plt.figure()
        self._writers = []
        self._every = max(1, int(every))
        self._count = 0
        self._async = bool(asynchronous)
        self._handle = self._make_live_handle(live)
        if on_disk:
            Path(on_disk).mkdir(parents=True, exist_ok=True)
        if self._async:
            import threading

            self._latest = None
            self._cv = threading.Condition()
            self._stopping = False
            self._thread = threading.Thread(target=self._draw_worker,
                                            daemon=True)
            self._thread.start()
        self._draw(skel_data)

    def _make_live_handle(self, live):
        """IPython display handle for the self-updating notebook view
        (None when disabled or outside a kernel)."""
        if live is False:
            return None
        try:
            from IPython import get_ipython
            from IPython.display import display
        except ImportError:
            if live:
                raise RuntimeError(
                    "live=True requires IPython (run inside a notebook)")
            return None
        ip = get_ipython()
        in_kernel = ip is not None and type(ip).__name__ == "ZMQInteractiveShell"
        if live is None and not in_kernel:
            return None  # auto mode: plain scripts get no live view
        return display(self._fig, display_id=True)

    def _draw(self, simul):
        self._fig.clf()
        self._plot_function(simul, self._fig)
        self._fig.canvas.draw_idle()
        if self._handle is not None:
            # in-place replacement of the published figure: the notebook
            # cell re-renders as the loop runs (DynamicMap/Pipe semantics)
            self._handle.update(self._fig)
        if self.on_disk:
            target = Path(self.on_disk) / (
                "%s_%i.%s" % (self._on_disk_name, simul.i, self._fmt)
            )
            self._fig.savefig(target, **self._renderer_args)
            self._writers.append(target)

    def _on_emit(self, simul):
        self._count += 1
        if (self._count - 1) % self._every:
            return
        if self._async:
            with self._cv:
                self._latest = simul
                self._cv.notify()
        else:
            self._draw(simul)

    def _draw_worker(self):
        while True:
            with self._cv:
                while self._latest is None and not self._stopping:
                    self._cv.wait()
                if self._latest is None:
                    return
                simul, self._latest = self._latest, None
            try:
                self._draw(simul)
            except Exception:  # noqa: BLE001 - viz must not kill the loop
                logger.exception("display draw failed")

    def close(self):
        """Drain the pending frame and stop the worker thread (no-op for
        synchronous displays)."""
        if self._async:
            with self._cv:
                self._stopping = True
                self._cv.notify()
            self._thread.join(timeout=10)

    def connect(self, stream):
        stream.sink(self._on_emit)

    @property
    def figure(self):
        return self._fig

    def _repr_mimebundle_(self, *args, **kwargs):
        return self._fig.canvas._repr_mimebundle_(*args, **kwargs)

    # ------------------------------------------------------------- factories
    @staticmethod
    def display_fields(simul, keys="all", on_disk=None, on_disk_name=None,
                       every=1, asynchronous=False, live=None,
                       **renderer_args):
        """One curve per 1D dependent/helper variable, redrawn per step
        (reference displays.py:89-113)."""

        def plot_function(data, fig):
            selected = (
                data.fields.keys() if keys == "all" else keys
            )
            selected = [selected] if isinstance(selected, str) else selected
            x_name = data.fields.template.coords[0]
            selected = [
                k for k in selected
                if k not in data.fields.template.coords
                and np.asarray(data.fields[k]).ndim == 1
            ]
            x = np.asarray(data.fields[x_name])
            for iax, var in enumerate(selected):
                ax = fig.add_subplot(len(selected), 1, iax + 1)
                ax.plot(x, np.asarray(data.fields[var]))
                ax.set_ylabel(var)
            fig.suptitle("t = %g" % data.t)

        if on_disk and not on_disk_name:
            keys_label = "all" if keys == "all" else "-".join(np.atleast_1d(keys))
            on_disk_name = "%s_%s" % (simul.id, keys_label)

        display = Display(simul, plot_function, on_disk=on_disk,
                          on_disk_name=on_disk_name or "triflow_plot",
                          every=every, asynchronous=asynchronous,
                          live=live, **renderer_args)
        display.connect(simul.stream)
        return display

    @staticmethod
    def display_probe(simul, function, xlabel=None, ylabel=None, buffer=None,
                      on_disk=None, on_disk_name=None, every=1,
                      asynchronous=False, live=None, **renderer_args):
        """Scalar time-series probe with a ring buffer
        (reference displays.py:115-142)."""
        history = deque([], buffer)
        if not xlabel:
            xlabel = str(uuid4())[:6]
        if not ylabel:
            ylabel = function.__name__
        if ylabel == "<lambda>":
            warnings.warn(
                "Anonymous function used, appending random prefix "
                "to avoid label confusion"
            )
            ylabel += str(uuid4())[:8]

        def plot_function(data, fig):
            history.append(function(simul))
            ax = fig.add_subplot(111)
            ax.plot(list(history))
            ax.set_xlabel(xlabel)
            ax.set_ylabel(ylabel)

        if on_disk and not on_disk_name:
            on_disk_name = "%s_%s" % (simul.id, ylabel)

        display = Display(simul, plot_function, on_disk=on_disk,
                          on_disk_name=on_disk_name or "triflow_probe",
                          every=every, asynchronous=asynchronous,
                          live=live, **renderer_args)
        display.connect(simul.stream)
        return display
