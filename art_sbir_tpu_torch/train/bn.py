"""BatchNorm recalibration after training.

Counterpart of ``art_sbir_tpu/train/bn.py``. The triplet step normalizes
each modality by its own batch statistics (reference `train.py:27-37`),
but inference normalizes both modalities with one set of running
statistics, an EMA of a mixture of about a third sketches and two thirds
photos. On modality-bimodal data trained from scratch that opens a gap
between the train-mode and eval-mode embeddings; the reference escapes it
only through pretrained CLIP weights (`models.py:275-360`,
`utils.py:132-206`).

* :func:`collect_batch_stats` replaces the EMA with the population
  statistics of a sweep: the mean over batches of each batch's own
  (mean, biased variance), which every train-mode ``BatchNorm2d``
  records as it runs (no EMA is inverted).
* :func:`embed_fn_per_modality` embeds each modality with its own set.

Statistics are dicts in the state dict's layout
(``<layer>.running_mean`` and ``<layer>.running_var``), so
``model.load_state_dict(stats, strict=False)`` installs them and
``models/<run>_bn_sketch.pt`` holds one set.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Iterable, Iterator, Tuple

import torch
from torch import nn

from art_sbir_tpu_torch.models.resnet import BatchNorm2d

Stats = Dict[str, torch.Tensor]


def _bn_layers(model: nn.Module):
    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, BatchNorm2d)]


@torch.no_grad()
def collect_batch_stats(model: nn.Module, batches: Iterable[torch.Tensor]
                        ) -> Stats:
    """Population BatchNorm statistics over ``batches`` (each a model
    input, (B, H, W, C)): one train-mode forward a batch, each layer's
    recorded batch moments summed in batch order, then divided by the
    count (the JAX package's estimator). The model's parameters, running
    statistics and mode are left as they were. Raises if ``batches`` is
    empty."""
    layers = _bn_layers(model)
    saved = {n: [b.clone() for b in m.buffers()] for n, m in layers}
    was_training = model.training
    acc: Dict[str, list] = {}
    k = 0
    try:
        for _, m in layers:
            m.record = []
        model.train()
        for x in batches:
            model(x)
            for n, m in layers:
                (mean, var), = m.record
                m.record.clear()
                if n in acc:
                    acc[n][0] = acc[n][0] + mean
                    acc[n][1] = acc[n][1] + var
                else:
                    acc[n] = [mean, var]
            k += 1
    finally:
        for n, m in layers:
            m.record = None
            for b, s in zip(m.buffers(), saved[n]):
                b.copy_(s)
        model.train(was_training)
    if k == 0:
        raise ValueError("BN recalibration needs at least one batch")
    out: Stats = {}
    for n, (mean, var) in acc.items():
        out[f"{n}.running_mean"] = mean / k
        out[f"{n}.running_var"] = var / k
    return out


def _interleave(*iterables: Iterable) -> Iterator:
    """One item of each in turn until all are spent."""
    its = [iter(i) for i in iterables]
    while its:
        for it in list(its):
            try:
                yield next(it)
            except StopIteration:
                its.remove(it)


def recalibrate_mixed(model: nn.Module,
                      sketches: Callable[[], Iterable[torch.Tensor]],
                      photos: Callable[[], Iterable[torch.Tensor]]) -> Stats:
    """One set from an interleaved sketch and photo sweep: drop-in running
    statistics. Each batch stays single-modality, as train-mode BN saw the
    data; the average weighs the modalities by their share of the
    sweep."""
    return collect_batch_stats(model, _interleave(sketches(), photos()))


def recalibrate_per_modality(model: nn.Module,
                             sketches: Callable[[], Iterable[torch.Tensor]],
                             photos: Callable[[], Iterable[torch.Tensor]]
                             ) -> Tuple[Stats, Stats]:
    """(sketch_stats, photo_stats): embed each modality with its own set
    (see :func:`embed_fn_per_modality`)."""
    return (collect_batch_stats(model, sketches()),
            collect_batch_stats(model, photos()))


def recalibrate_from_catalog(model: nn.Module, catalog, *, mode: str,
                             image_size: int = 224,
                             resize_mode: str = "square",
                             batch_size: int = 64, max_batches: int = 64,
                             device: str | torch.device = "cpu"):
    """The CLIs' sweep: the TRAIN catalog's sketches and photos (the data
    whose statistics training saw), decoded and CLIP-normalized as the
    gallery is, on ``device``. ``mode='mixed'`` gives one drop-in set,
    ``'per_modality'`` the pair (sketch_stats, photo_stats). A partial
    tail batch is dropped (the sweep is statistics, not coverage) and
    each modality is capped at ``max_batches`` batches."""
    from art_sbir_tpu_torch.data.loader import GalleryLoader
    from art_sbir_tpu_torch.train.prepare import finish_gallery_batch

    def sweep(paths):
        loader = GalleryLoader(paths, image_size, resize_mode)
        n_full = min(len(loader) // batch_size, max_batches)
        if n_full == 0:
            raise ValueError(
                f"BN recalibration needs >= {batch_size} images per "
                f"modality; catalog has {len(loader)}")

        def gen():
            for i in range(n_full):
                x = torch.from_numpy(loader(i * batch_size, batch_size))
                yield finish_gallery_batch(x.to(device))

        return gen

    sk, ph = sweep(catalog.sketch_paths), sweep(catalog.photo_paths)
    if mode == "mixed":
        return recalibrate_mixed(model, sk, ph)
    if mode == "per_modality":
        return recalibrate_per_modality(model, sk, ph)
    raise ValueError(f"unknown bn_recalibrate mode {mode!r}")


def with_stats(model: nn.Module, stats: Stats) -> nn.Module:
    """An eval-mode copy of ``model`` with ``stats`` as its running
    statistics."""
    out = copy.deepcopy(model).eval()
    bad = out.load_state_dict(stats, strict=False).unexpected_keys
    if bad:
        raise ValueError(f"unexpected BatchNorm statistics {bad}")
    return out


def embed_fn_per_modality(model: nn.Module, sketch_stats: Stats,
                          photo_stats: Stats) -> Tuple[Callable, Callable]:
    """(embed_sketch, embed_photo): eval-mode embedders, each with its own
    statistics; a classification model's tuple reduces to the
    embedding."""
    def embedder(m):
        def embed(x):
            with torch.no_grad():
                out = m(x)
            return out[0] if isinstance(out, (tuple, list)) else out
        return embed

    return (embedder(with_stats(model, sketch_stats)),
            embedder(with_stats(model, photo_stats)))
