"""Plots for a results folder: loss curves, top-k accuracy bars and
retrieval-sample grids.

Counterpart of ``art_sbir_tpu/viz/plots.py::visualize`` and what it calls
(reference `visualization.py`): the grid frames the ground-truth image in
green (`visualization.py:196-241`), and ``visualize`` dispatches on the
inference dict's shape (`visualization.py:262-273`). matplotlib and PIL
are imported inside the functions: a host without them can still run the
evaluation and write its JSON. :func:`triplet_grid`, pix2pix's sample
sheet, draws with PIL alone, so it is written where matplotlib is
missing. The comparison sheets come with the CLI that draws them.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def loss_curves(train_losses: Sequence[float], test_losses: Sequence[float],
                out: Path, title: str = "Triplet loss",
                ylabel: str = "loss") -> Path:
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(7, 4.5))
    ax.plot(np.arange(1, len(train_losses) + 1), train_losses, label="train",
            marker="o")
    if test_losses:
        ax.plot(np.arange(1, len(test_losses) + 1), test_losses, label="test",
                marker="o")
    ax.set_xlabel("epoch")
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    ax.legend()
    fig.tight_layout()
    fig.savefig(out)
    plt.close(fig)
    return Path(out)


def iteration_loss_curves(itrain: Sequence[float], itest: Sequence[float],
                          frequency: int, out: Path) -> Optional[Path]:
    if not itrain:
        return None
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(7, 4.5))
    step = max(frequency, 1)
    ax.plot(np.arange(1, len(itrain) + 1) * step, itrain,
            label="train (window)")
    if itest:
        ax.plot(np.arange(1, len(itest) + 1) * step, itest,
                label="test (mini eval)")
    ax.set_xlabel("iteration")
    ax.set_ylabel("loss")
    ax.set_title("Iteration losses")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out)
    plt.close(fig)
    return Path(out)


def topk_bars(topk_acc: Sequence[float], out: Path, label: str = "") -> Path:
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(7, 4.5))
    ks = np.arange(1, len(topk_acc) + 1)
    ax.bar(ks, np.asarray(topk_acc) * 100.0)
    ax.set_xticks(ks)
    ax.set_xlabel("k")
    ax.set_ylabel("top-k accuracy [%]")
    ax.set_title(f"Top-k retrieval accuracy {label}".strip())
    for k, v in zip(ks, topk_acc):
        ax.text(k, v * 100.0, f"{v * 100:.1f}", ha="center", va="bottom",
                fontsize=8)
    fig.tight_layout()
    fig.savefig(out)
    plt.close(fig)
    return Path(out)


def _load_thumb(path: str, size: int = 128) -> np.ndarray:
    """A (size, size, 3) thumbnail; a grey tile where the image cannot be
    read (a moved corpus must not stop the report)."""
    from PIL import Image

    try:
        with Image.open(path) as img:
            return np.asarray(img.convert("RGB").resize((size, size),
                                                        Image.BICUBIC))
    except OSError:
        return np.full((size, size, 3), 230, np.uint8)


def retrieval_grid(retrieval_samples: List[Dict], out: Path, k: int = 10,
                   thumb: int = 128) -> Optional[Path]:
    """Rows = queries; column 0 the sketch, columns 1..k the retrieved
    images; the ground-truth match gets a green frame (reference
    `visualization.py:196-241`)."""
    if not retrieval_samples:
        return None
    plt = _pyplot()
    rows = len(retrieval_samples)
    fig, axes = plt.subplots(rows, k + 1, figsize=(1.3 * (k + 1), 1.4 * rows))
    axes = np.atleast_2d(axes)
    for r, sample in enumerate(retrieval_samples):
        (sketch_path, entries), = sample.items()
        axes[r, 0].imshow(_load_thumb(sketch_path, thumb))
        axes[r, 0].set_title("query", fontsize=7)
        sketch_stem = Path(sketch_path).stem.split("-")[0]
        for c, (img_path, dist) in enumerate(entries[:k], start=1):
            ax = axes[r, c]
            ax.imshow(_load_thumb(img_path, thumb))
            ax.set_title(f"{dist:.2f}", fontsize=6)
            if Path(img_path).stem == sketch_stem:
                for spine in ax.spines.values():
                    spine.set_edgecolor("lime")
                    spine.set_linewidth(4)
        for c in range(k + 1):
            axes[r, c].set_xticks([])
            axes[r, c].set_yticks([])
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    plt.close(fig)
    return Path(out)


def _tile(img, size: int) -> np.ndarray:
    """An HWC (or HW) uint8 or [0, 1] float image -> (size, size, 3)
    uint8."""
    from PIL import Image

    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    pil = Image.fromarray(img).convert("RGB")
    return np.asarray(pil.resize((size, size), Image.BICUBIC))


def triplet_grid(triplets: Sequence, out: Path,
                 titles=("sketch", "positive", "negative"),
                 tile: int = 128) -> Path:
    """Rows of three HWC images (uint8, or floats in [0, 1]; one channel
    drawn grey) under a strip of ``titles`` (JAX ``viz/plots.py:141``),
    drawn with PIL."""
    from PIL import Image, ImageDraw

    pad, head = 4, 16
    width = 3 * tile + 4 * pad
    sheet = Image.new("RGB", (width, head + len(triplets) * (tile + pad)
                              + pad), "white")
    draw = ImageDraw.Draw(sheet)
    for c, title in enumerate(titles[:3]):
        draw.text((pad + c * (tile + pad), 2), title, fill="black")
    for r, trip in enumerate(triplets):
        for c, img in enumerate(trip[:3]):
            sheet.paste(Image.fromarray(_tile(img, tile)),
                        (pad + c * (tile + pad), head + r * (tile + pad)))
    sheet.save(out)
    return Path(out)


def visualize(folder: Path | str, training_dict: Dict,
              inference_dict: Dict) -> None:
    """Write every applicable plot into the run folder, dispatching on the
    dicts' shapes like the reference ``visualize``
    (`visualization.py:262-273`). Where matplotlib is not installed it
    says so and draws nothing."""
    import importlib.util

    if importlib.util.find_spec("matplotlib") is None:
        print("matplotlib is not installed: no plots", flush=True)
        return
    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    if training_dict.get("train_losses"):
        tl = training_dict["train_losses"]
        if isinstance(tl, dict):  # VAE/GAN multi-loss dicts
            for key, series in tl.items():
                loss_curves(series,
                            training_dict.get("test_losses", {}).get(key, []),
                            folder / f"loss_{key}.png", title=key, ylabel=key)
        else:
            loss_curves(tl, training_dict.get("test_losses", []),
                        folder / "losses.png")
            iteration_loss_curves(
                training_dict.get("itrain_losses", []),
                training_dict.get("itest_losses", []),
                training_dict.get("iteration_loss_frequency", 1),
                folder / "iteration_losses.png")

    def _plot_inference(d: Dict, suffix: str = "") -> None:
        if "topk_acc" in d:
            topk_bars(d["topk_acc"], folder / f"topk_acc{suffix}.png")
        if d.get("retrieval_samples"):
            retrieval_grid(d["retrieval_samples"],
                           folder / f"retrieval_samples{suffix}.png")

    if "drawing_stats" in inference_dict:  # kaggle/mixed two-pass shape
        _plot_inference(inference_dict["drawing_stats"], "_drawings")
        _plot_inference(inference_dict.get("sketch_stats", {}), "_sketches")
    elif inference_dict:
        _plot_inference(inference_dict)
