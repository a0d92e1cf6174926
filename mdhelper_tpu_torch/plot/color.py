r"""
Plot colors
===========

Color helpers, a copy of :mod:`mdhelper_tpu.plot.color`.
"""

import colorsys
from typing import Union

import matplotlib.colors as mc

__all__ = ["adjust_lightness"]


def adjust_lightness(
    colors: Union[str, tuple, list], amount: float
) -> Union[tuple, list]:
    r"""Adjust color luminosity in HLS space: ``amount < 1`` darkens,
    ``amount > 1`` lightens.  Accepts a named color, hex string, RGB
    tuple, or a list thereof.
    """

    if isinstance(colors, list):
        return [adjust_lightness(color, amount) for color in colors]

    h, l, s = colorsys.rgb_to_hls(
        *mc.to_rgb(
            mc.cnames[colors]
            if isinstance(colors, str) and colors in mc.cnames
            else colors
        )
    )
    return colorsys.hls_to_rgb(h, max(0, min(1, amount * l)), s)
