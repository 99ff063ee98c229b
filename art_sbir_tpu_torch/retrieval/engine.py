"""Offline retrieval evaluation: the reference ``run_inference`` contract
(reference `inference.py:140-165`), and the pieces of a trained run that
the evaluation and the serving CLI share.

Counterpart of ``art_sbir_tpu/retrieval/engine.py``. Embed the
dedup-sorted gallery once (or load a feature cache), embed every query
sketch in batches, then rank and score on the device
(:func:`~art_sbir_tpu_torch.retrieval.rank.evaluate_retrieval`). Kaggle
and Mixed datasets get a second pass with the human sketchit queries
against the same gallery (`inference.py:156-165`) and return
``{'image_features', 'drawing_stats', 'sketch_stats'}``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

from art_sbir_tpu_torch.core.checkpoint import checkpoint_path, load_state_dict
from art_sbir_tpu_torch.core.device import resolve_device
from art_sbir_tpu_torch.core.metrics import Timer
from art_sbir_tpu_torch.data import get_datasets
from art_sbir_tpu_torch.data.catalog import InferenceCatalog
from art_sbir_tpu_torch.data.loader import GalleryLoader
from art_sbir_tpu_torch.models.resnet import create_encoder
from art_sbir_tpu_torch.retrieval.embed import (embed_batched,
                                                load_image_features,
                                                save_image_features)
from art_sbir_tpu_torch.retrieval.rank import evaluate_retrieval


def rebuild_catalogs(data_dict: Dict, data_root=None):
    """The run's (train, test) catalogs, rebuilt from ``data_params.json``
    (a Mixed run's version appended to its dataset name)."""
    name = data_dict["dataset"]
    if "Mixed" in name and "version" in data_dict:
        name += data_dict["version"]
    return get_datasets(
        dataset=name, size=data_dict.get("size", 1.0),
        sketch_type=data_dict.get("sketch_type", "contour_drawings"),
        img_type=data_dict.get("img_type", "photos"),
        img_format=data_dict.get("img_format", "jpg"), root=data_root)


def rebuild_test_catalog(data_dict: Dict, data_root=None):
    """The run's test catalog (:func:`rebuild_catalogs`)."""
    return rebuild_catalogs(data_dict, data_root)[1]


def restore_encoder(folder: str, param_dict: Dict, models_root,
                    device: torch.device) -> Tuple[torch.nn.Module, bool]:
    """(the run's bf16 encoder in eval mode, whether it was restored):
    restored from ``<models_root>/<folder>.pt``, else a seed-0 fresh
    init. Runs trained with another tower geometry record it in
    ``training_params.json`` (``param_dict``)."""
    model_type = param_dict.get("model_type") or folder.split("_")[0]
    model = create_encoder(
        with_classification=("with_classification" in model_type
                             or "WithClassification" in folder),
        num_classes=int(param_dict.get("num_classes", 125)),
        num_classes2=int(param_dict.get("num_classes2", 0)),
        compute_dtype=torch.bfloat16, device=device, seed=0,
        input_resolution=int(param_dict.get("image_size", 224)),
        width=int(param_dict.get("width", 64)),
        layers=tuple(param_dict.get("layers", (3, 4, 6, 3))))
    ckpt = checkpoint_path(models_root, folder)
    if ckpt.is_file():
        model.load_state_dict(load_state_dict(ckpt))
    return model, ckpt.is_file()


def embed_test_gallery(forward_fn: Callable, dataset, image_size: int = 224,
                       resize_mode: Optional[str] = None,
                       batch_size: int = 256,
                       device: str | torch.device | None = None,
                       loaders: Optional[List[GalleryLoader]] = None,
                       mesh=None) -> Tuple[List[str], torch.Tensor]:
    """(image paths, (N, D) features on ``device``): the catalog's photos
    deduplicated and sorted (:class:`InferenceCatalog`), embedded by
    ``forward_fn`` (each batch split over ``mesh``, when given, by
    :func:`embed_batched`). ``resize_mode=None`` takes the catalog
    family's geometry. ``loaders`` collects the loader (its decode
    time)."""
    resize_mode = resize_mode or getattr(dataset, "resize_mode", "square")
    image_paths = InferenceCatalog(dataset.photo_paths).image_paths
    loader = GalleryLoader(image_paths, image_size, resize_mode)
    if loaders is not None:
        loaders.append(loader)
    return image_paths, embed_batched(forward_fn, loader, len(loader),
                                      batch_size, device=device,
                                      return_device=True, mesh=mesh)


def run_inference(forward_fn: Callable[[torch.Tensor], torch.Tensor],
                  dataset, feature_folder: Optional[str] = None,
                  loss_type: str = "euclidean", image_size: int = 224,
                  resize_mode: Optional[str] = None, batch_size: int = 256,
                  mesh=None, model_name: str = "ModifiedResNet",
                  feature_root: Path | str = Path("data/image_features"),
                  kaggle_queries=None, save_features: bool = True,
                  query_forward_fn: Optional[Callable] = None,
                  device: str | torch.device | None = None,
                  trace: Optional[Dict] = None) -> Dict:
    """``forward_fn`` maps a uint8 (B, S, S, 3) tensor on ``device`` to
    (B, D) embeddings (or a tuple whose first item they are),
    preprocessing inside. ``dataset`` is a test catalog with
    ``sketch_paths`` / ``photo_paths`` / ``state_dict``.

    ``feature_folder``: rank against that cache under ``feature_root``
    instead of embedding the gallery; else the embedded gallery is saved
    there (``save_features``). ``query_forward_fn`` (default
    ``forward_fn``) embeds the sketch queries. ``resize_mode=None`` takes
    the catalog family's geometry (the reference embeds gallery and
    queries, the sketchit pass too, with the calling dataset's transform,
    `inference.py:74,148,158`). ``device``: the card unless ``'cpu'`` is
    passed. ``mesh`` (:class:`~art_sbir_tpu_torch.parallel.mesh.Mesh`):
    the gallery and query batches are split over its devices
    (``forward_fn`` picks its replica by the batch's device), and
    :func:`evaluate_retrieval` shards the gallery over it; ``device`` is
    then ``mesh.devices[0]``.

    ``trace``: a dict that receives what the run saw: ``gallery`` (the
    ranked features), ``gallery_embed_s`` (None from a cache),
    ``decode_s`` (the loaders' decoding, which overlaps the embedding)
    and, per query pass, ``passes``: the ``queries``, their ``embed_s``
    and :func:`evaluate_retrieval`'s trace. Times wait for the device."""
    dev = resolve_device(device if mesh is None else mesh.devices[0])
    timer = Timer()
    clock = Timer(device_sync=dev.type == "cuda") if trace is not None else None
    resize_mode = resize_mode or getattr(dataset, "resize_mode", "square")
    loaders: List[GalleryLoader] = []

    if feature_folder:
        image_paths, gallery = load_image_features(feature_folder,
                                                   feature_root)
        feature_name, gallery_s = feature_folder, None
    else:
        # stays on the device for the ranking; only the cache goes to disk
        image_paths, gallery = embed_test_gallery(
            forward_fn, dataset, image_size, resize_mode, batch_size, dev,
            loaders, mesh=mesh)
        gallery_s = clock.restart() if clock else None
        # save_features=False for transient evaluations that would
        # otherwise leave a timestamped folder per call
        feature_name = save_image_features(
            model_name, dataset.state_dict["dataset"], image_paths,
            gallery.cpu().numpy(), root=feature_root) if save_features else None

    query_fn = query_forward_fn or forward_fn
    passes: List[Dict] = []

    def _eval(catalog) -> Dict:
        qloader = GalleryLoader(catalog.sketch_paths, image_size, resize_mode)
        loaders.append(qloader)
        if clock:
            clock.restart()
        queries = embed_batched(query_fn, qloader, len(qloader), batch_size,
                                device=dev, return_device=True, mesh=mesh)
        sub = None
        if clock:
            sub = {"queries": queries, "embed_s": clock.restart()}
            passes.append(sub)
        return evaluate_retrieval(queries, gallery, catalog.sketch_paths,
                                  image_paths, loss_type=loss_type,
                                  start_time=timer.elapsed(), device=dev,
                                  mesh=mesh, trace=sub)

    stats = _eval(dataset)
    name = dataset.state_dict["dataset"]
    two_pass = ("Kaggle" in name or "Mixed" in name) and \
        kaggle_queries is not None
    if two_pass:
        stats = {"image_features": feature_name, "drawing_stats": stats,
                 "sketch_stats": _eval(kaggle_queries)}
    else:
        stats["image_features"] = feature_name
    if trace is not None:
        trace.update(gallery=gallery, gallery_embed_s=gallery_s,
                     decode_s=sum(ld.decode_s for ld in loaders),
                     passes=passes)
    return stats
