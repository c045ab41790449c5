"""Plotting helpers (counterpart of fastbox_tpu/plot.py; reference
fastbox/plot.py).  matplotlib is imported when a plot is made."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["animate_field"]


def animate_field(field, axis=2, interval=80, vmin=None, vmax=None,
                  cmap="cividis", fps=8):
    """Animate slices of a 3D field along an axis (plot.py:7-67).

    ``field`` is a tensor on any device or an array.  Returns a matplotlib
    FuncAnimation; in a notebook, call ``.to_html5_video()`` on the result
    as with the reference.
    """
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation

    if isinstance(field, torch.Tensor):
        field = field.detach().cpu().numpy()
    field = np.moveaxis(np.asarray(field), axis, 0)
    if vmin is None:
        vmin = np.nanpercentile(field, 1.0)
    if vmax is None:
        vmax = np.nanpercentile(field, 99.0)

    fig, ax = plt.subplots()
    im = ax.imshow(field[0], vmin=vmin, vmax=vmax, cmap=cmap)
    fig.colorbar(im, ax=ax)

    def update(i):
        im.set_data(field[i])
        ax.set_title(f"slice {i}")
        return (im,)

    return FuncAnimation(fig, update, frames=field.shape[0],
                         interval=interval, blit=False)
