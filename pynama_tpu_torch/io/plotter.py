"""matplotlib chart helpers for error/convergence studies
(reference `src/viewer/plotter.py:17-90`)."""
from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


class DualAxesPlotter:
    """Two quantities vs a shared x axis on twin y axes."""

    def __init__(self, name_left: str, name_right: str):
        self.name_left = name_left
        self.name_right = name_right

    def plot(self, x, y_left, y_right, filename: str, xlabel: str = "time"):
        plt = _plt()
        fig, axl = plt.subplots()
        axr = axl.twinx()
        axl.plot(x, y_left, "b-", label=self.name_left)
        axr.plot(x, y_right, "r--", label=self.name_right)
        axl.set_xlabel(xlabel)
        axl.set_ylabel(self.name_left, color="b")
        axr.set_ylabel(self.name_right, color="r")
        fig.tight_layout()
        fig.savefig(filename, dpi=150)
        plt.close(fig)


class Plotter:
    """Simple multi-series line plot."""

    def plot(self, series: dict, filename: str, xlabel: str = "",
             ylabel: str = "", loglog: bool = False):
        plt = _plt()
        fig, ax = plt.subplots()
        for label, (x, y) in series.items():
            (ax.loglog if loglog else ax.plot)(x, y, marker="o",
                                               label=str(label))
        ax.set_xlabel(xlabel)
        ax.set_ylabel(ylabel)
        ax.grid(True, which="both", alpha=0.3)
        ax.legend()
        fig.tight_layout()
        fig.savefig(filename, dpi=150)
        plt.close(fig)


class ErrorPlotter(Plotter):
    """loglog error-vs-resolution convergence chart (reference
    generateChart, run_case.py:57-77: error vs N* = 2*(ngl-1))."""

    def plot_convergence(self, ngls, errors_by_tau: dict, filename: str):
        series = {f"tau={tau}": (2 * (np.asarray(ngls) - 1), errs)
                  for tau, errs in errors_by_tau.items()}
        self.plot(series, filename, xlabel="N* = 2(ngl-1)",
                  ylabel="||error||", loglog=True)
