r"""
Axis and legend helpers
=======================

Tabular legends, a copy of :mod:`mdhelper_tpu.plot.axis` (host-only
matplotlib code).
"""

from typing import Any

import matplotlib.patches
import numpy as np

__all__ = ["set_up_tabular_legend"]


def set_up_tabular_legend(
    rows: list,
    cols: list,
    *,
    hlabel: str = None,
    vlabel: str = None,
    hla: str = "left",
    vla: str = "top",
    condense: bool = False,
    **kwargs,
) -> dict[str, Any]:
    r"""Build the keyword arguments for a tabular (grid) Matplotlib
    legend: invisible handles laid out so row/column labels form a
    table around the entries.

    Parameters
    ----------
    rows, cols : `list` of `str`
        Row and column labels.
    hlabel, vlabel : `str`, keyword-only, optional
        Overall horizontal / vertical axis labels.
    hla : `str`, keyword-only, default ``"left"``
        Horizontal label alignment (``"left"`` or ``"center"``).
    vla : `str`, keyword-only, default ``"top"``
        Vertical label alignment (``"top"`` or ``"center"``).
    condense : `bool`, keyword-only, default False
        Merge the vertical label column into the row-label column.

    Returns
    -------
    legend_kwargs : `dict`
        Pass to ``ax.legend(**legend_kwargs)``; fill in the data
        handles at the empty slots afterwards.
    """

    hpad = bool(vlabel) - condense + 1
    vpad = bool(hlabel) + 1
    nrow = len(rows) + vpad
    ncol = len(cols) + hpad

    labels = ["" for _ in range(nrow * ncol)]
    if vlabel:
        labels[
            vpad + (len(rows) // 2 if vla == "center" else -condense)
        ] = vlabel
    iv = vpad + nrow * (bool(vlabel) - condense)
    labels[iv:iv + len(rows)] = rows
    if hlabel:
        labels[
            (2 + (hla == "center") * (int(np.ceil(len(cols) / 2)) - 1))
            * nrow
        ] = hlabel
    labels[hpad * nrow + bool(hlabel)::nrow] = cols

    return {
        "handles": [
            matplotlib.patches.Rectangle(
                (0, 0), 0.1, 0.1, ec="none", fill=False
            )
            for _ in range(len(labels))
        ],
        "labels": labels,
        "ncol": ncol,
        **kwargs,
    }
