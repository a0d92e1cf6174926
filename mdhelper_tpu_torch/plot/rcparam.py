r"""
Matplotlib rcParams presets
===========================

Journal-specific figure sizing and rcParams, a copy of
:mod:`mdhelper_tpu.plot.rcparam`.
"""

import matplotlib as mpl

__all__ = ["FIGURE_SIZE_LIMITS", "update"]

#: Figure size guidelines (inches) for common publishers.
FIGURE_SIZE_LIMITS = {
    "acs": {
        "max_single_width": 3.25,
        "max_double_width": 7,
        "max_length": 9.5,
    },
    "aip": {
        "max_single_width": 3.37,
        "max_double_width": 6.69,
        "max_length": 8.25,
        "min_font_size": 8,
    },
    "rsc": {
        "max_single_width": 3.26771654,
        "max_double_width": 6.73228346,
        "max_length": 9.17322835,
    },
}


def update(
    journal: str = None,
    font_scaling: float = 1,
    size_scaling: float = 1,
    **kwargs,
) -> None:
    r"""Update Matplotlib rcParams for publication-quality figures,
    optionally sized for a journal (``"acs"``, ``"aip"``, ``"rsc"``).

    9 pt fonts (scaled by `font_scaling`), tight legends, 1200 dpi
    savefig, TeX text, and a 4:3 single-column figure when `journal` is
    given.
    """

    fig_size = (
        {}
        if journal is None
        else {
            "figure.figsize": (
                size_scaling
                * FIGURE_SIZE_LIMITS[journal]["max_single_width"],
                size_scaling
                * 3
                * FIGURE_SIZE_LIMITS[journal]["max_single_width"]
                / 4,
            )
        }
    )
    mpl.rcParams.update(
        {
            "axes.labelsize": font_scaling * 9,
            "figure.autolayout": True,
            "font.size": font_scaling * 9,
            "legend.columnspacing": 1,
            "legend.edgecolor": "1",
            "legend.fontsize": font_scaling * 9,
            "legend.handlelength": 1.25,
            "legend.labelspacing": 0.25,
            "savefig.dpi": 1_200,
            "xtick.labelsize": font_scaling * 9,
            "ytick.labelsize": font_scaling * 9,
            "text.usetex": True,
        }
        | fig_size
        | kwargs
    )
