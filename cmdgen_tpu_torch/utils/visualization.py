"""3-D chain rendering: PNG frame series + animated GIF (counterpart of
``cmdgen_tpu/utils/visualization.py``).

Typed pharmacophore points (one color per class) denoising inside a grey
pocket context, camera and axis limits held fixed across frames.
matplotlib, imageio and PIL are imported inside the functions that use
them, so the module imports without them.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from cmdgen_tpu_torch.chem.constants import PHAR_DECODER
from cmdgen_tpu_torch.containers import PointCloud

# one color per pharmacophore class (chem/constants.PHAR_DECODER order)
PHAR_COLORS = [
    "#e6194b",  # Aromatic
    "#f58231",  # Hydrophobe
    "#4363d8",  # PosIonizable
    "#911eb4",  # NegIonizable
    "#3cb44b",  # Acceptor
    "#42d4f4",  # Donor
    "#f032e6",  # LumpedHydrophobe
    "#9A6324",  # others
]


def _plot_frame(ax, coords, types, pocket_coords, lim, type_names):
    if pocket_coords is not None and len(pocket_coords):
        ax.scatter(*pocket_coords.T, s=8, c="#bbbbbb", alpha=0.5,
                   depthshade=False)
    seen = set()
    for i in range(len(coords)):
        t = int(types[i]) if types is not None else 0
        label = None
        if type_names and t not in seen:
            label = type_names[t]
            seen.add(t)
        ax.scatter(*coords[i], s=90, c=PHAR_COLORS[t % len(PHAR_COLORS)],
                   label=label, depthshade=False)
    ax.set_xlim(*lim[0])
    ax.set_ylim(*lim[1])
    ax.set_zlim(*lim[2])
    ax.set_axis_off()


def render_chain(
    out_path,
    frames: np.ndarray,
    mask: np.ndarray,
    types: Optional[np.ndarray] = None,
    pocket_coords: Optional[np.ndarray] = None,
    type_names: Optional[Sequence[str]] = None,
    fps: int = 8,
    max_frames: int = 60,
    hold_last: int = 8,
    save_pngs: bool = False,
    elev: float = 18.0,
    azim_sweep: float = 60.0,
):
    """Render a denoising chain to ``out_path`` (.gif).

    frames: [F, N, 3] coordinates over the reverse chain (first = noise),
    mask: [N] valid-point mask, types: [N] class indices colored per class
    (typically the final sample's types), pocket_coords: [Nq, 3] context.
    The camera sweeps ``azim_sweep`` degrees over the chain; the final
    frame is held for ``hold_last`` repeats. ``save_pngs`` also writes the
    individual frames next to the GIF (the reference's PNG-series output).
    Returns the list of rendered frame arrays.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    frames = np.asarray(frames)
    keep = np.asarray(mask) > 0.5
    stride = max(len(frames) // max_frames, 1)
    sel = list(range(0, len(frames), stride))
    if sel[-1] != len(frames) - 1:
        sel.append(len(frames) - 1)

    # axis limits from the *final* geometry + pocket, with margin; early
    # noisy frames may wander outside and simply clip
    ref_pts = [frames[-1][keep]]
    if pocket_coords is not None:
        ref_pts.append(np.asarray(pocket_coords))
    ref = np.concatenate(ref_pts, axis=0)
    center = ref.mean(axis=0)
    half = max(float(np.abs(ref - center).max()) * 1.15, 3.0)
    lim = [(center[d] - half, center[d] + half) for d in range(3)]

    images = []
    for j, f in enumerate(sel):
        fig = plt.figure(figsize=(5, 5), dpi=110)
        ax = fig.add_subplot(111, projection="3d")
        ax.view_init(elev=elev,
                     azim=-60 + azim_sweep * j / max(len(sel) - 1, 1))
        _plot_frame(ax, frames[f][keep],
                    np.asarray(types)[keep] if types is not None else None,
                    pocket_coords, lim, type_names)
        ax.set_title(f"step {f + 1}/{len(frames)}", fontsize=9)
        if type_names:
            ax.legend(loc="upper right", fontsize=7)
        fig.canvas.draw()
        img = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
        images.append(img)
        if save_pngs:
            fig.savefig(out_path.parent / f"chain_{j:04d}.png")
        plt.close(fig)

    images.extend([images[-1]] * hold_last)
    try:
        import imageio.v2 as imageio

        imageio.mimsave(out_path, images, format="GIF", fps=fps, loop=0)
    except ImportError:  # Pillow fallback
        from PIL import Image

        pil = [Image.fromarray(im) for im in images]
        pil[0].save(out_path, save_all=True, append_images=pil[1:],
                    duration=int(1000 / fps), loop=0)
    return images


def render_chain_for_pocket(
    model,
    pocket_coords: np.ndarray,
    pocket_onehot: np.ndarray,
    out_path,
    n_phar: Optional[int] = None,
    n_phar_max: int = 16,
    timesteps: Optional[int] = None,
    keep_frames: int = 60,
    generator=None,
    **render_kwargs,
):
    """Sample one reverse chain for a pocket on the model's device and
    render it to a GIF. The node count is ``n_phar``, else a draw from the
    model's size prior, else 5, clipped to [1, n_phar_max]."""
    dev = model.device
    nq = pocket_onehot.shape[0]
    pocket = PointCloud(
        x=torch.as_tensor(pocket_coords, dtype=torch.float32, device=dev)[None],
        h=torch.as_tensor(pocket_onehot, dtype=torch.float32, device=dev)[None],
        mask=torch.ones((1, nq), device=dev),
    )
    if n_phar is None:
        if model.size_prior is not None:
            n_phar = int(model.size_prior.sample_conditional_n1(
                torch.full((1,), nq, device=dev), generator)[0])
        else:
            n_phar = 5
    n_phar = max(1, min(n_phar, n_phar_max))
    phar, pocket_out, frames = model.sample_chain_given_pocket(
        pocket, torch.full((1,), n_phar, device=dev), n_phar_max,
        keep_frames=keep_frames, timesteps=timesteps, generator=generator)
    # render in the sampler's output frame: the pocket context moves along
    # with the chain (the CoM bookkeeping moves the pocket, not the chain)
    return render_chain(
        out_path,
        frames[:, 0].cpu().numpy(),
        phar.mask[0].cpu().numpy(),
        types=phar.h[0].cpu().numpy().argmax(-1),
        pocket_coords=pocket_out.x[0].cpu().numpy(),
        type_names=list(PHAR_DECODER),
        **render_kwargs,
    )
